#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gelly_streaming_tpu_torch) on one
NVIDIA card: build every kernel, hold each against its plain PyTorch
version, drive streaming GraphSAGE, streaming Connected Components (also
at the north-star shape, 2^27 edges, in one window), the degree stream,
window triangles, the neighborhood aggregations,
incremental PageRank, bipartiteness, exact triangles, the device
spanner, the device vertex dictionary, the sampling triangle estimators
and iterative CC end to end, kill and resume the headline cell under the
supervisor, run CC under the auto-K controller and the event-time sliding
windows, run sharded socket ingest into CC and event time, kill and
relaunch a 2-process coordinated cluster on the card, serve live queries
from streaming summaries on the card (in process and over the RPC wire
with a replica failover), route queries over sharded replicas, run the
mesh (an NCCL world of one, and gloo worlds of 2 and 4 ranks on the one
card), train GraphSAGE and GCN at config #5's width (on one device and
across meshes on the one card), and print the results.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device  — a CUDA card must be present; prints its name and power limit
   as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``.
2. build   — compiles ``gelly_streaming_tpu_torch/csrc/*.cu`` with nvcc for
   sm_90a (one nvcc per source, started together), prints ptxas's register
   and spill report, and counts the ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA
   load) instructions of the tensor-core kernel in ``cuobjdump -sass``;
   either count at 0 fails ("not checked" where there is no cuobjdump).
3. kernels — ``fused_sage_matmul`` against ``fused_sage_matmul_plain`` on the
   card, each call asserting which kernel it launched: the two layer shapes
   of BASELINE config #5 (bf16 takes "tc", f32 "simt"); the ragged "tc"
   shapes V in {1, 100, 257, 65537} x (F, O) in {(48, 72), (136, 264)};
   the "simt" shapes of the first slice, f32 and bf16 views whose address
   is 2 bytes off 16-byte alignment; relu and none. Then, at the config #5
   shapes in bf16, the times of the kernel, its plain version, the library
   (cuBLAS ``addmm`` on pre-concatenated operands, timed here only) and the
   "simt" kernel, each launch timed alone with a cold L2 (see ``cold_ms``),
   beside the bound; and the warm loop of the first slice on a labelled
   line of its own.
4. slice   — config #5 streaming GraphSAGE through the port's entry points:
   ``SimpleEdgeStream`` with ``CountWindow(1 << 18)`` over
   ``IdentityDict(1 << 16)`` into ``StreamingGraphSAGE`` with a
   ``TableFeatureSource``, dims [128, 256, 128] in bf16, 4 windows (the
   edge accumulator crosses 2^18 -> 2^19 -> 2^20). The counts are set to 0
   just before: the run must launch "tc" exactly twice per window and
   "simt" never; the last window's embeddings are held against a reference
   composed on the card from the plain functions; then edges/s, ms per
   window and where the time goes.
4b. sage aggregate — the SAGE mean kernel (``csrc/sage_aggregate.cu``
   behind ``ops/sage_aggregate.py:segment_mean``) at the
   ``sage_products_w8m`` cell's last window: the cell's R-MAT stream (scale
   21, 123,718,280 messages, made on the card by ``graphbench.generate``)
   carried as a ``MessageCSR`` in its 15 windows of 2^23 (each append timed;
   the last checked against a stable sort of the whole stream), then at F =
   104 and 256 in bf16 the kernel's time against its ``E (4 + 2F) + 2VF``
   byte bound, two launches bit-identical, the plain version's time and
   agreement, and the edge-list composition it replaces
   (``models/graphsage.py:mean_aggregate``, the ``library_ms``).
5. cc      — streaming Connected Components, the headline cell of
   ``bench.py:bench_cc_e2e``: the ``livejournal`` surrogate (R-MAT scale 21,
   2^24 edges, made here by the port's ``ensure_corpus`` and cached under the
   temporary directory) through ``datasets.stream_file`` with
   ``CountWindow(1 << 20)``, ``IdentityDict(1 << 21)`` and
   ``prefetch_depth=2`` into ``ConnectedComponents()`` (carry "auto", which
   must pick "forest"), ``sync()`` inside the timed region. The native
   library must have loaded. One warm pass, then the median of 3 steady
   passes: edges/s, p50/p95 window latency, host reads per window. The last
   window's labels are held exactly against ``scipy``'s connected
   components of the same edges regenerated here from the R-MAT seeds (no
   parsing); the first 4 windows' labels of the host and dense carries and
   of the forest carry with ``superbatch=4`` must equal the forest carry's.
   Then one profiled pass: the top operations by device time, the busy
   share, the peak device memory, and the device time and launches of each
   CC step (``cc.*`` spans as ``record_function`` ranges).
   northstar — the north-star shape, ``bench.py:2566 run_northstar``
   step for step on the card (unnumbered, so the later phases keep their
   numbers): the ``livejournal-xl`` surrogate (R-MAT scale 23, 2^27 edges,
   ids below 2^23), its columns made here from the seeds the port's
   ``synthesize`` uses and written as its binary cache by
   ``datasets.write_binary`` (the timed passes read only that file); scipy's
   labels once; the compiled baseline and the Flink proxy
   (``native.cc_baseline``, ``native.flink_proxy``) once each on the file's
   columns, their component count equal to scipy's. Then three passes, each
   a warm pass and the median of 3 (of 2 for the identity pass), ``sync()``
   timed: ``window_1m`` (``CountWindow(1 << 20)``, ``device_encode=True,
   min_vertex_capacity=
   1 << 23``, ``prefetch_depth=2``: 128 windows), ``window_1m_identity``
   (the same with ``IdentityDict(1 << 23)``: carry "forest") and
   ``window_100m`` (``CountWindow(max(2^27, 100_000_000))``, device
   encoded: exactly 1 window): edges/s, p50/p95, host reads a window, the
   carry, each pass's peak device memory and the process's peak host
   memory after it, ``vs_baseline`` and ``vs_flink`` beside the card and
   the host CPU; after each, the last
   emission's labels equal to scipy's on the seen ids (0 mismatches) and
   its component count equal to the baseline's. Then the one-window pass
   profiled (no prefetch): host spans, busy share, top operations and the
   device steps against ``dict_encode_bytes``. The phase frees its columns,
   its oracle and the file before phase 6.
6. degrees — BASELINE config #1, ``bench.py:bench_degrees_e2e``: phase 5's
   corpus through its binary cache (``datasets.binary_cache``, as
   ``bench.py`` builds it) into ``datasets.stream_file`` with
   ``CountWindow(1 << 20)``, ``IdentityDict(1 << 21)``,
   ``prefetch_depth=2``, then ``get_degrees().batches()`` drained. One warm
   pass, then the median of 3 steady passes: edges/s and ms per window.
   One more pass under ``torch.cuda.set_sync_debug_mode("warn")`` counts
   the host syncs inside the window loop (expected 0) and after it (the
   stream's one wait). The degrees after the 16 windows must equal
   ``np.bincount`` of the regenerated R-MAT edges, and the last window's
   emitted ids and degrees the numpy oracle, exactly. Then a
   ``DegreeDistribution`` run of 2^20 seeded +/- events on the card must
   equal the same run on the CPU, window by window.
7. triangles — BASELINE config #3, ``bench.py:bench_window_triangles_e2e``:
   ``make_stream(1 << 17, 2 << 20, seed=9)`` through ``SimpleEdgeStream``
   (``CountWindow(1 << 20)``, ``IdentityDict(1 << 17)``) into
   ``WindowTriangles(CountWindow(1 << 20)).run_stream``, the counts left on
   the card until the pass ends. The same timing and sync count as phase 6;
   each window's count must equal scipy's ``(A @ A).multiply(A).sum()`` on
   the degree-oriented, deduplicated adjacency, and window 0's per-vertex
   counts the port's on the CPU.
8. neighborhood — window 0 of the config #3 stream with seeded float edge
   values, ``slice(direction=ALL)``: ``reduce_on_edges("sum")``, an
   associative callable, ``fold_neighbors`` (lockstep turns printed),
   ``apply_on_neighbors`` and ``flat_apply_on_neighbors``, each timed on
   the card (emission included) and held against the port on the CPU
   (floats within ``NBR_TOL``).
   Phases 6 and 7 end with a profile of one pass each, the device steps
   opened as ``record_function`` ranges: the top operations by device
   time, the busy share, device-to-host copies, peak memory, and each
   step's device ms, launches and byte bound per window (phases 9-12 end
   the same way).
9. pagerank — BASELINE config #4, ``bench.py:bench_pagerank``:
   ``make_stream(1 << 18, 1 << 20, seed=11)`` in ``CountWindow(1 << 18)``
   over ``IdentityDict(1 << 18)`` into ``IncrementalPageRank(tol=1e-6,
   max_iter=50)``, ``sync()`` inside the timed region; one warm pass (its
   last window's fixpoint operands kept), then the median of 3 with the
   fixpoint kernel's count (``ops/pagerank_kernels.py:LAUNCHES``) set to 0
   just before: edges/s, ms and iterations a window, one launch and no host
   read a window. The final ranks must be within 1e-5 of a float64 scipy
   run of the reference's procedure and every window's iterations within 2
   of its; ``superbatch=4`` within 1e-6 of ``superbatch=1``. Then a scale
   pass on the first 8 windows of phase 6's binary cache (2^20 edges each
   over 2^21 ids, written to a binary file of their own) against the same
   oracle, one launch a window. Then, at two shapes (the kept last window
   of config #4 and of the scale pass), the kernel of ``csrc/pagerank.cu``
   against ``fixpoint_plain`` (each rank within 1e-6 and within 1e-4 of
   itself plus 1e-10, the ranks' sum within 1e-5 of 1, iterations within
   2); its cold time in turns with the others', with no iteration and with
   one (set-up ms, ms an iteration), beside the plain version's, one
   iteration of ``torch.mv`` on a sparse CSR matrix of the carry times the
   iterations, the byte rule's bound and the bound of re-reading the edges
   every iteration, and the window's in-degree figures; and last the profile,
   the kernel's ctypes launches added by name (the pass profiled again
   where the trace holds fewer of them than ``LAUNCHES`` counted).
10. bipartiteness — ``bench.py:bench_bipartiteness_e2e``: the binary cache
   through ``stream_file`` into ``BipartitenessCheck()`` (carry "auto" must
   pick "forest"), timed like phase 9; the verdicts after window 0 and the
   last window equal to scipy's components of the 2V-node double cover;
   the same edges mapped to ``(u & ~1, v | 1)`` must be bipartite, window
   0's coloring proper; on 4 windows of both streams the host and dense
   carries and ``superbatch=4`` equal to the forest carry.
11. exact triangles — ``bench.py:bench_exact_triangles``:
   ``make_stream(1 << 17, 1 << 20, seed=15)`` in ``CountWindow(1 << 18)``,
   the batches unread until the pass ends; edges/s, host syncs in the loop
   (0 expected); after every window the running total and per-vertex
   counts equal to scipy's ``(A @ A).multiply(A)`` on the prefix graph.
12. spanner — ``bench.py:bench_spanner``: ``make_stream(1 << 18, 1 << 20,
   seed=17)``, k = 2, ``DeviceSpanner(expected_edges=1 << 20)``; edges/s,
   host syncs in the loop (0); the edge set equal to the port's on the CPU
   and every dropped edge within 2 spanner hops (sparse products); then
   k = 3 on the 2^18-edge prefix and on 2^16 edges over 2^12 vertices in
   4 windows, each equal to the CPU's. Then the reference's own k = 3 cell
   (``bench.py:3754 spanner_k3_eps``: the same stream, windows, dict and
   ``expected_edges`` with k = 3), its window loop through the search
   kernel of ``csrc/k_reach.cu`` (one launch a search): the counted run
   (the kernel's launches from 0, one a search; each window's first search
   captured); (a) the kernel against its plain version, exactly, on
   seeded spanners (V in {1, 333, 4099}, W in {1, 3, 32}, no, some and all
   columns live, k = 1 to 4) and on the captured first batches of windows
   1-3; host syncs in the loop (0); edges/s; every dropped edge of a
   seeded sample of 2^14 within 3 spanner hops (sparse products); the
   profile's step table over windows 0-1 with the bytes' bound and the
   frontier traffic's; and one search of window 3's first batch timed in
   turns with a cold L2 (the search, also with its bitmap read from device
   memory, and the plain version) beside its bounds: the bytes', the dense
   frontier's and the active traffic's (from a numpy BFS of the batch).
13. device-encode — the CC cell with vertex compaction on the card
   (``bench.py:bench_cc_e2e_device`` and ``bench_cc_e2e_device_text``):
   phase 6's binary cache with ``device_encode=True, min_vertex_capacity=
   1 << 21`` (the declared id bound), and the text corpus with
   ``device_encode=True, dense_ids=False`` and a ``1 << 10`` hint (the table
   grows by re-padding from host novelty tracking), each in
   ``CountWindow(1 << 20)`` with ``prefetch_depth=2`` into
   ``ConnectedComponents()``, ``sync()`` timed. Device-encoded blocks carry
   no host columns, so the carry is the dense one (as in the reference).
   One warm pass, the median of 3: edges/s, p50/p95, the CC fold's host
   reads and its kernel's launches a window (``csrc/cc_fold.cu``; each
   pass must make one launch and no host read a window). The last
   window's partition, decoded to raw ids, must
   equal scipy's; window 0's compact ids the host ``VertexDict``'s; the
   ingest's window loop (parse, upload, encode) makes 0 host syncs; the
   ``probe`` ends non-negative and equal to the ids seen. A profiled pass
   (no prefetch, so the encode's ranges are in the trace) gives the busy
   share and ``dict.encode``'s device ms and launches a window against
   ``dict_encode_bytes``, and ``engine.dispatch``'s with the fold kernel's
   ctypes launches credited by name, against ``cc_fold_bytes``. Then the
   corpus's first 2 windows mapped to sparse int32 ids (an injective affine
   map mod 2^31 - 1) must encode as the host dict does. After it, the fold
   kernel alone at the benchmark's CC shapes (a scale-23 R-MAT stream in
   compact ids, 128 windows of 2^20 edges over 2^23 labels): each window
   between CUDA events, one window with a cold L2 and a 2^20-edge path fed
   in reverse, against the ``cc_fold_bytes`` bound; every 16th window
   bit-equal to the plain composition, which is timed there too.
14. sampling — ``make_stream(1 << 15, 1 << 22, seed=19)`` made
   duplicate-free and loop-free, in windows of 2^20 over ``vertex_count =
   1 << 15`` (the vectorized form). k is the least power of two at which
   the expected ``beta_sum``, ``k T / (m (V - 2))`` for scipy's exact
   triangle count T, is at least 100; the final estimate must lie within 4
   binomial standard errors of T; every window's state must equal the
   port's on the CPU fed the same uniforms, and the incidence estimator's
   output the broadcast one's. Edges/s, ms a window, busy share,
   ``sampling.window`` device ms and launches. The scan form (the route of
   every id space above 46,340; one launch of ``csrc/reservoir_scan.cu`` a
   draw batch): (a) its first 2^10 edges over 2^16 vertices at k = 2^12,
   one launch, every state equal to the CPU's fed the same uniforms and to
   the plain version's on the card, with the ms per edge of both; (b) the
   whole stream over 2^16 vertices at the reference's 10,000 samples in
   windows of 2^20 (2477 draw batches): a warm pass and the median of 3
   (edges/s, sample-steps/s, ms a window), then a counted pass with the
   kernel's count set to 0 just before (one launch and two draws a batch,
   host reads a window); the estimate within 4 standard errors of T at
   ``p = T / (m (2^16 - 2))``, the incidence estimator equal; the kernel
   against its plain version on window 0's first 2^12 edges at k = 10,000,
   bit for bit; (c) one draw batch (1677 edges) timed cold in turns with
   the plain version and the two draws, beside the closed form's byte
   bound ``4nk + 8n + 32k`` (the kernel reads the coins once and the third
   draws only at each sample's last replacement) and the edge-by-edge
   rule ``8nk + 8n + 28k``, and a cold ``torch.amax`` over the batch's
   coins (a streaming read of the ``4nk`` bytes, a yardstick of the cold
   method); and the profile of a pass (busy share,
   ``sampling.scan`` device ms with the kernel's ctypes launches, bytes by
   the closed form).
15. iterative cc — the first 4 windows (2^18 edges each) of
   ``make_stream(1 << 18, 1 << 20, seed=21)`` through ``IdentityDict`` (the
   incremental host path) and through ``device_encode`` (the diff path on
   the card): after each window the labels accumulated from the emissions
   must equal scipy's least raw id of each component, and the two paths
   each other; ms a window of each with the fold kernel's launches a
   window, and a profile of each (``icc.*`` ranges, the fold's ctypes
   launches credited to ``engine.dispatch``).
16. durability — the headline cell of phase 5 under the resilience layer:
   (a) through ``example/common.supervised_emissions`` with a barrier
   every 4 windows, 3 kept, and ``FaultPlan(kill_at_window=9,
   kill_site="pipeline.item")``: exactly one restart, the resume from the
   barrier at window 8 (the ``checkpoint.restore`` spans), the replayed
   window deduped, carry "forest", the last window's labels equal to phase
   5's (scipy's); (b) the head barrier flipped by ``corrupt_file``: a fresh
   ``AutoCheckpoint`` resumes from the rotated barrier at 12 with
   ``resilience.ckpt_rejected == 1`` and the same labels; (c) phase 6's
   ``DegreeDistribution`` events under ``AutoCheckpoint(every=2)``, the run
   abandoned after 5 windows and resumed: equal to the uninterrupted run
   window by window; (d) the head barrier, written on the card, restored
   on the CPU to the same labels; (e) edges/s with a barrier every 4
   windows and with none, in 3 alternating pairs; each barrier's
   ``checkpoint.barrier_wait`` and ``checkpoint.serialize`` ms, its bytes,
   its parts (the forest's download and host resolve, the pickle, the
   checksum, the write) and the restore ms, against the bound of its bytes
   over a plain D2H copy and a plain file write measured here; and the
   cadence ``every="auto"`` settles on.
17. autok  — ``superbatch="auto"`` (the ``AutoK`` controller) on the card,
   CC with the forest carry, ``sync()`` timed: (a) the cliff cell of
   ``bench.py:764 bench_autotune_pair``, phase 5's corpus prefix of 2^21
   edges (its binary cache; 2^23 until phase northstar joined) in
   ``CountWindow(1024)`` over
   ``IdentityDict(1 << 21)``: the hand K of ``auto_superbatch_k`` (256)
   and auto (from K = 1) alternate, a warm pass each and 2 pairs; edges/s
   of each and their ratio, the controller's ``k_path``, its retunes and
   final K, and the host reads a window of a pass pinned at that K; the
   last window's labels equal to scipy's. (b) the shift cell of
   ``bench.py:846``: ``ScheduledCountWindow`` 1024 -> 8192 edges at window
   512 over 2^22 edges folded into 2^16 ids, ``AutoK(k_max=64,
   decide_groups=2)`` with a ``PrefetchTuner``: a ``window-shift`` decision
   and every emission equal to the run pinned by ``AutoK(k0=1, k_max=1)``.
   (c) PageRank at ``bench.py:908`` (2^15 edges into 2^14 ids): auto, the
   per-window loop and the adaptive path pinned at K = 1 alternate (a warm
   pass each, 3 rounds); the controller's final K and path are printed
   (the reference's CPU record holds K = 1) and the ranks must be within
   1e-6 of the per-window run's; and a kill at
   ``pipeline.item`` 12 under ``superbatch="auto"`` through
   ``AutoCheckpoint(every=4)`` must resume to the uninterrupted labels.
18. eventtime — ``bench.py:2089 bench_eventtime`` at half its length: 48
   panes of 8192 edges (96 until phase northstar joined) over a drifting key
   span of 2^15, a window of 8 panes: the
   sliding aggregator's edges/s (one warm pass, the median of 2), a pass
   with ``verify=True`` (every window against the from-scratch oracles),
   and every expiry's retraction against a rebuild of the three summaries
   (0 mismatches, the cycles, the median refolded edges, the
   retract-versus-rebuild ratio). Then the kill at ``eventtime.retract``
   before the commit recovers to the uninterrupted answers; the skewed
   two-shard stream of ``tests/test_eventtime.py:513`` drops no record and
   its closed panes under ``ConnectedComponents(superbatch="auto")`` on the
   card equal ``superbatch=1``; and the busy share of a profiled pass of
   that path and of the aggregator alone.
   Phases 17 and 18 print their ``fused_sage_matmul`` launches (0: their
   paths have no hand-written kernel).
19. ingest — slice 7b on the card. (a) ``bench.py:1895 bench_ingest`` at a
   quarter of its size: 2^20 R-MAT edges (scale 20, seed 7; 2^22 until phase
   northstar joined) served by the port's
   ``python -m gelly_streaming_tpu_torch.core.ingest --serve`` peer
   subprocesses (started together, no card visible to them), per-shard
   windows of 2^14, ``superbatches(8)``, frames of 8192 edges, 8 queued
   windows; cells ``c1_text`` (one ``SocketEdgeSource``), ``c2_text``,
   ``c4_text``, ``c1_binary``, ``c2_binary``, ``c4_binary``
   (``ShardedEdgeSource``): edges/s as the median of 3 passes with the
   reference's endpoint (groups assembled and encoded), each pass's
   ``source.backpressure_s`` and malformed frames and lines (0), and every
   pass must consume exactly 2^20 edges. (b) The ``c4_binary`` and
   ``c1_text`` streams into ``ConnectedComponents(superbatch=8)`` on the
   card, ``sync()`` timed, a warm pass and the median of 3: edges/s, the
   emission interval's p50 (and a group's), host reads a window, the carry
   (must be "forest"); the final components decoded to raw ids must equal
   scipy's of the R-MAT edges regenerated here; then the busy share and top
   kernels of one profiled ``c4_binary`` pass. (c) Phase 18's drifting
   stream partitioned with ``ts`` over 2 shards, served by ``serve_blobs``
   as GSEW v2 frames, through ``ShardedEdgeSource(timestamps=True)
   .windows_ts()`` into ``drive_sliding(SlidingGraphAggregator(8, 1,
   nshards=2, verify=True))``: edges/s, the pane closes, 0 mismatches and 0
   late drops. (d) ``run_mp_sweep(processes=2, windows=6, window_edges=128,
   superbatch=2, every=2, corrupt=True)`` with every worker's CC on the card
   (the reference's 12 windows cut to 6, the least with a corrupt point),
   then one kill point against an ``ExchangeDaemon`` (``transport=
   "socket"``): every point oracle-identical with byte-identical
   dictionaries and a flight dump, the corrupt epoch skipped with its
   rejection in the merged event log; the time from each kill to the
   relaunch's first emission and how many points' workers agreed on one
   epoch. (e) The locally runnable legs of ``bench.py:run_transport_bench``
   for shared-dir and socket: p50/p99 of a 4 KiB put plus get, a 2-rank
   allgather and an election. Prints its ``fused_sage_matmul`` launches (0).
20. serving — slice 9a on the card. (a) ``bench.py:1704 bench_serving`` at
   its defaults: ``make_stream(1 << 17, 8 << 18, seed=23)`` in
   ``CountWindow(1 << 18)`` over ``IdentityDict(1 << 17)``, CC on the card;
   plain and served passes alternate (a warm pass each, then 2 pairs), the
   served one behind ``StreamServer(max_pending=1 << 15)`` with a paced
   client (bursts of 256 ``ConnectedQuery`` every 10 ms): edges/s of each,
   the ingest overhead, query p50/p99, staleness, answered and rejected,
   host reads a query batch; the served pass's obs log must replay to its
   ``ServingStats`` snapshot and every answer equal scipy's labels of the
   edge prefix at its snapshot's window. (b) Phase 5's cell (the surrogate,
   16 windows of 2^20, ``prefetch_depth=2``) unserved, then served with
   bursts of ``ConnectedQuery`` + ``ComponentSizeQuery`` on the query
   engine's device path (``"auto"``) and on its host path
   (``prefer_host=True``): edges/s, query p50/p99, host reads a batch; after
   the stream ends 4096 answers at staleness 0 equal to scipy's components
   and sizes, and the first published snapshot's labels unchanged; the busy
   share of a profiled served pass; the four query steps on the final
   forest (ms a call between CUDA events over 20 calls, host reads,
   launches) against ``query_step_bytes``; then the degree, rank and bipartiteness servables
   on their cells (phases 6, 9, 10) at 4 windows, each answering equal to
   its stream's own final view. (c) ``resilience/chaos.py:
   run_rpc_scenario`` at the config of ``BENCH_SERVING_RPC_CPU.json`` (4
   clients, batches of 16, 5 ms pace, the primary killed at sweep 1500,
   lease 0.4 s, seed 4321, autotune) with both replicas' tables on the
   card: 0 client-visible failures, promotion by lease lapse, the primary's
   flight dump, every trace completed; the outage, steady and promotion
   window p50/p99. Prints its ``fused_sage_matmul`` launches (0).
21. routing — slice 9b on the card; every shard replica holds its tables
   on the card (``device="cuda"``), no router touches it. (a)
   ``example/sharded_ingest_serving.run`` at phase 19's per-shard window
   over the headline's id bound (2 shards, windows of 2^14, 2^22 edges over
   2^21 vertices, seed 23): edges/s and the final answers,
   which must equal scipy's components of the regenerated edges. (b)
   ``resilience/chaos.py:run_sharded_scenario`` (c1 direct, c2 cache off
   and on with the oracle, the joined trace and the shard kill, c3 delta
   against full pulls under churn, c4) with the reference's other defaults
   and windows of 2^17, at 2^21 vertices and 2^22 edges halved together
   while c3's full pull of its 4x keyspace would not fit one wire frame
   (``fabric/wire.py:DEFAULT_MAX_FRAME``, the reference's 8 MiB), each cut
   printed: 0 oracle mismatches, 0 load failures, 0 failures on either side
   of the shard kill with the standby promoted, a joined trace, and the
   churn cell's oracle identity; the hit rate, full merges and headline
   ratios are printed, not gated. (c) ``run_storm_scenario`` at the
   geometry of ``bench.py --storm --smoke`` (2^11 vertices, 2^12 edges,
   phases of 1.2 s, 2 clients, 64 oracle checks): 0 client-visible
   failures in every phase, promotion, the split adopted, 0 post-split
   oracle mismatches, 0 transaction violations, a trace joining client,
   surviving router and both post-split shards; the surviving router's
   epoch (stamped on its reply frames). (d) A router's host work at 2^21
   ids and 2^22 edges on the machine's CPU: the shards' host fold, one full
   pull's encode and decode, the cross-shard merge and a 1 % delta apply,
   each checked. Prints its ``fused_sage_matmul`` launches (0).
22. mesh   — slice 6 on the card. (a) An NCCL world of one on cuda:0
   (``multihost.initialize`` with no launcher, ``make_mesh(1)``): every
   ``comm`` collective inside ``shard_map`` (all-reduce sum/min/max, the
   all-gather, the degree-2 butterfly, the sharded segment sum and min) on
   tables of 2^21 int32 (CC's at the headline id bound), each equal to its
   local form, with its host ms a call; then ``StreamingGraphSAGE(mesh=)``
   at config #5's width (phase 4's stream, 4 windows) against the forward
   without a mesh, bit for bit under deterministic algorithms, launching
   ``fused_sage_matmul`` 8 times ("tc"), the counts set to 0 just before.
   (b) Gloo worlds of 2 and 4 ranks started with ``torch.multiprocessing``
   spawn and a ``FileStore``, every rank's tensors on the one card: the
   collectives as in (a) with their ms; CC bulk and tree with the forest
   carry on phase 5's 2^22-edge corpus prefix (edges/s after a warm pass),
   PageRank on phase 9's cell, bipartiteness (and the same edges made
   bipartite), ``window_triangle_count_sharded`` on phase 7's window 0,
   and the sharded GraphSAGE forward; integers equal to the width-1 run
   on the card and to scipy exactly, ranks within 1e-5 of scipy and of
   each other, embeddings bit-equal across ranks and within the slice's
   tolerance of width 1. The operations gloo runs through host memory
   (the butterfly's point-to-point buffers) are counted and printed.
   These numbers are transport on one card, not scaling.
23. train  — slice 3 on the card. (a) GraphSAGE at config #5's width (phase
   4's stream over its 4 windows as one edge list of 2^20, V = 2^16, dims
   [128, 256, 128] in bf16, f32 targets from a seed): 8 steps each of SGD
   and Adam with remat off and on, under deterministic algorithms, the
   counts set to 0 just before: each run's loss descends, launches "tc"
   exactly 2 times a step (4 with remat) and "simt" never, and remat
   changes no parameter bit for bit; the first step's gradients against
   autograd through ``fused_sage_matmul_plain`` on the card; then ms a
   step after a warm step, peak memory and the step's bound
   (``train_step_bytes``). (b) GCN at the same width: the same, with no
   kernel to count, its gradients against the same step on the CPU. (c)
   The sharded step: an NCCL world of one with ``make_mesh(1, 1)`` (bit
   for bit (a)'s run), then a gloo world of 4 with every rank on the one
   card, meshes 1x2 and 2x1 on its first two ranks and 2x2 on all four,
   3 SGD and 3 Adam steps each: every rank's gathered parameters and
   losses bit-equal, within ``TR_MESH_TOL`` of (a)'s width-1 run; each
   collective's count and the staged buffers; one 2x2 step profiled on
   rank 0. (d) ``dryrun_multichip(4)`` on every rank of that world, and
   ``entry()`` on the card against the CPU.
24. a ``{"kernels": [...]}`` line, and last the ``{"ok": true, ...}`` line.
Each phase's wall seconds are printed after it.

TF32 is off for float32 matmuls (``torch.backends.cuda.matmul.allow_tf32 =
False``), so the plain version's f32 products are full f32.
"""

import functools
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np

# BASELINE config #5 (bench.py: bench_graphsage_e2e)
N_VERTICES = 1 << 16
WINDOW = 1 << 18
N_WINDOWS = 4
DIMS = [128, 256, 128]
STREAM_SEED = 13

# phase 4b: the sage_products_w8m cell's stream and its widths
SA_SCALE = 21
SA_EDGES = 123_718_280
SA_WINDOW = 1 << 23
SA_RMAT = (0.57, 0.19, 0.19)
SA_WIDTHS = (104, 256)
SA_SEED = 25
SA_TIMED = 5  # launches of the kernel timed at each width

# streaming CC, the headline cell (bench.py: CORPUS, WINDOW, ID_BOUND)
CC_CORPUS = "livejournal"
CC_WINDOW = 1 << 20
CC_ID_BOUND = 1 << 21
CC_PREFIX_WINDOWS = 4
CC_STEADY_PASSES = 3

# the north-star shape (bench.py:2566 run_northstar): the scale-23 surrogate
NS_CORPUS = "livejournal-xl"
NS_WINDOW = 1 << 20
NS_BIG_WINDOW = 100_000_000  # the one-window pass takes max(edges, this)
NS_ID_BOUND = 1 << 23
NS_PASSES = 3  # after a warm pass; the median is the cell
NS_IDENTITY_PASSES = 2  # the host-bound identity pass: the median of 2, cut for time
NS_DEVICE = "cuda"

# BASELINE config #4 (bench.py: bench_pagerank): 4 windows of 2^18
PR_VERTICES = 1 << 18
PR_EDGES = 1 << 20
PR_WINDOW = 1 << 18
PR_SEED = 11
PR_TOL = 1e-6
PR_MAX_ITER = 50
PR_SCALE_WINDOWS = 8  # the scale pass's windows of 2^20; 16 until phase northstar joined
# final ranks against the float64 oracle (tests/test_pagerank_sage.py:47),
# iterations within 2 of it (the L1 change at tol 1e-6 is near the
# float32 noise floor), superbatch 4 against 1 (float atomics)
PR_RANK_TOL = 1e-5
PR_ITER_SLACK = 2
PR_K4_TOL = 1e-6
# the kernel against fixpoint_plain (float atomics in both): each rank
# within 1e-6, and within 1e-4 of itself plus 1e-10 (at 2^18 vertices a
# rank is about 1e-6, as small as the absolute bound); the sum within 1e-5
PR_KERNEL_TOL = 1e-6
PR_KERNEL_RTOL = 1e-4
PR_KERNEL_FLOOR = 1e-10
PR_STEPS = ("pagerank.window", "pagerank.fixpoint")
# the kernel, launched through ctypes, and its wrapper's module (its LAUNCHES)
PR_FOREIGN = {"pagerank.fixpoint": ("pagerank_fixpoint", "pagerank_kernels")}
# csrc/pagerank.cu's split: a row of more than PR_ROW_THREAD entries goes to
# warps, in pieces of at most PR_PIECE
PR_ROW_THREAD, PR_PIECE = 32, 1024

# bipartiteness (bench.py: bench_bipartiteness_e2e) on phase 5's corpus
BIP_STEPS = ("bip.cover_step", "cc.chase_and_group", "cc.propagate", "cc.commit_roots",
             "cc.window_prep", "cc.window_upload")

# exact triangles (bench.py: bench_exact_triangles): 4 windows of 2^18
ETC_VERTICES = 1 << 17
ETC_EDGES = 1 << 20
ETC_WINDOW = 1 << 18
ETC_SEED = 15
ETC_STEPS = ("tri.packed_prep", "tri.packed_count", "tri.merge_packed")

# the device spanner (bench.py: bench_spanner): k = 2, 4 windows of 2^18;
# k = 3 also on 2^16 edges over 2^12 vertices in 4 windows
SP_VERTICES = 1 << 18
SP_EDGES = 1 << 20
SP_WINDOW = 1 << 18
SP_SEED = 17
SP3_EDGES = 1 << 16
SP3_VERTICES = 1 << 12
SP_STEPS = ("spanner.k2", "spanner.k2_merge")
SP3_STEPS = ("spanner.csr", "spanner.k_reach", "spanner.append")
# the search kernel, launched through ctypes, and its wrapper's module
SP3_FOREIGN = {"spanner.k_reach": ("k_reach_search", "reach_kernels")}
# the reference's own k = 3 cell, bench.py:3754 spanner_k3_eps =
# bench_spanner(k=3): the k = 2 cell's stream, windows, dict and
# expected_edges (the SP_* constants above) with DeviceSpanner(k=3)
SPK3_K = 3
SPK3_SAMPLE = 1 << 14  # dropped edges checked for a spanner path of <= 3 hops
SPK3_SAMPLE_SEED = 0
# the profiled pass covers the first 2 windows (window 1's 256 searches):
# a profile of all 4 took 33-40 s of the phase on an H100 host (its
# "seconds by stage" line), most of it reading the trace
SPK3_PROFILE_WINDOWS = 2
# phase (a): the search kernel against the plain version on seeded spanners
KR_VERTICES = (1, 333, 4099)  # ragged: none a multiple of the block
KR_BATCHES = (32, 96, 1024)  # W = 1, 3 and 32 words a vertex
KR_EDGES = 3  # spanner columns per vertex
# the spin before each timed call (about 2 ms of the card's clock): the host
# takes longer to enqueue the plain version's many launches than the flush
# takes to write, and the card must not wait on it inside the timing
KR_LEAD_CYCLES = 4_000_000
CC_STEPS = ("cc.window_prep", "cc.window_upload", "cc.chase_and_group", "cc.propagate",
            "cc.commit_roots", "cc.commit", "cc.forest_superbatch", "cc.resolve_flat",
            "cc.mirror_update", "engine.sync")

# BASELINE config #1 (bench.py: bench_degrees_e2e) on phase 5's corpus
DEG_STEPS = ("degree.update", "segment.count")
# a DegreeDistribution run held between the card and the CPU
DD_EVENTS = 1 << 20
DD_VERTICES = 1 << 14
DD_WINDOW = 1 << 16
DD_SEED = 5

# BASELINE config #3 (bench.py: bench_window_triangles_e2e)
TRI_VERTICES = 1 << 17
TRI_WINDOW = 1 << 20
TRI_WINDOWS = 2
TRI_SEED = 9
TRI_STEPS = ("tri.oriented_rows", "tri.membership", "csr.build", "segment.sort",
             "segment.count", "tri.plan", "window.rewindow", "window.pack")
STEADY_PASSES = 3

# phase 8: the seeded edge values of window 0, and the tolerance of its
# float results between the card and the CPU (relative to max(|x|, 1)):
# scatter-adds sum in another order on the card
NBR_SEED = 17
NBR_TOL = 1e-5

# the obs spans that open record_function ranges: device-side copies of
# them are ranges, not kernels
SPAN_PREFIXES = ("cc.", "window.", "engine.", "ingest.", "degree.", "tri.", "segment.",
                 "csr.", "pagerank.", "bip.", "spanner.", "dict.", "sampling.", "icc.",
                 "profile.")

# phase 13: the CC cell with vertex compaction on the device
# (bench.py: bench_cc_e2e_device, bench_cc_e2e_device_text)
DE_HINT = 1 << 10  # the growth form's pre-sizing hint
DE_STEPS = ("dict.encode", "engine.dispatch", "cc.propagate")
# the dense carry's window fold, a ctypes launch inside engine.dispatch
DE_FOREIGN = {"engine.dispatch": ("cc_fold_window", "cc_kernels")}
DE_SPARSE_WINDOWS = 2  # windows of the corpus mapped to sparse int32 ids
DE_SPARSE_PRIME = (1 << 31) - 1  # the map x -> (a x + b) mod p is injective
# the dense carry's window fold (csrc/cc_fold.cu) at the benchmark's CC cell's
# shapes: a Graph500 scale-23 stream (2^27 edges, A/B/C 0.57/0.19/0.19) in
# compact ids, 2^20-edge windows over a 2^23 table
CCF_SCALE = 23
CCF_WINDOW = 1 << 20
CCF_WINDOWS = 128
CCF_SEED = 23
CCF_PLAIN_EVERY = 16  # the plain composition timed and compared at these windows
# phase 14: the sampling triangle estimators
SMP_VERTICES = 1 << 15
SMP_EDGES = 1 << 22
SMP_SEED = 19
SMP_WINDOW = 1 << 20
SMP_TARGET_BETA = 100  # k: the least power of two with E[beta_sum] >= this
SMP_MAX_K = 1 << 24
SMP_SE = 4  # the estimate within this many binomial standard errors
SMP_SCAN_EDGES = 1 << 10  # 1 << 12 until phase 23 joined (PERF.md section 4)
SMP_SCAN_VERTICES = 1 << 16  # above the vectorized form's 46340
SMP_SCAN_K = 1 << 12
SMP_STEPS = ("sampling.window",)  # the scan form's range is "sampling.scan"
# the full scan pass: the whole stream over the scan's id space at the
# reference's CLI default of samples (gelly_streaming_tpu/library/sampling.py:
# 204-205, after BroadcastTriangleCount.java:216-217)
SMP_SCAN_FULL_K = 10_000
SMP_SCAN_CHECK_EDGES = 1 << 12  # window 0's edges held against the plain version
SMP_FOREIGN = {"sampling.scan": ("reservoir_scan", "sampling_kernels")}
# phase 15: iterative CC
ICC_VERTICES = 1 << 18
ICC_EDGES = 1 << 20
ICC_SEED = 21
ICC_WINDOW = 1 << 18
ICC_STEPS = ("icc.incremental", "icc.diff", "dict.encode", "engine.dispatch", "cc.propagate")

# phase 17 (bench.py:764 bench_autotune_pair, :846 bench_autotune_shift,
# :908 bench_autotune_pagerank_hold): the corpus prefix at the cliff window
AK_WINDOW = 1024
AK_EDGES = 1 << 21  # 1 << 23 until phase northstar joined (PERF.md section 4)
AK_HAND_K = 256  # bench.py:auto_superbatch_k(1024), BENCH_AUTOTUNE_CPU.json
AK_PAIRS = 2  # 3 until phase 19 joined the script (PERF.md section 4)
AK_SHIFT_EDGES = 1 << 22
AK_SHIFT_FOLD = 1 << 16
AK_SHIFT_SCHEDULE = ((0, 1024), (512, 8192))
AK_SHIFT_KMAX = 64
AK_PR_EDGES = 1 << 15
AK_PR_FOLD = 1 << 14
AK_KILL_ITEM = 12  # the group ordinal of the kill at pipeline.item
AK_KILL_EVERY = 4  # a barrier lands by group 4, before the kill

# phase 18 (bench.py:2089 bench_eventtime at half its length)
ET_PANES = 48  # the reference's 96 until phase northstar joined (PERF.md section 4)
ET_PER_PANE = 1 << 13
ET_VSPAN = 1 << 15
ET_WINDOW_PANES = 8
ET_CHUNK = 1 << 13
ET_KILL_PANES = 24
ET_KILL_AT = 13
ET_SKEW_RECORDS = 1 << 15  # tests/test_eventtime.py:513
ET_SKEW_VMAX = 4096
ET_SKEW = 3
ET_SKEW_WINDOW = 256
ET_STEADY_PASSES = 2  # 3 until phase 19 joined the script (PERF.md section 4)

# phase 16: durability on the headline cell. The supervised run keeps 3
# barriers, one every 4 windows, and is killed as prefetch item 9 is
# taken, so it resumes from the barrier at window 8; DegreeDistribution
# (phase 6's events) takes a barrier every 2 windows and dies after 5
DUR_EVERY = 4
DUR_KEEP = 3
DUR_KILL_ITEM = 9
DUR_RESUME_AT = 8
DUR_PAIRS = 3
DUR_DD_EVERY = 2
DUR_DD_KILL_AFTER = 5

# phase 19: sharded ingest (bench.py:1895 bench_ingest at its full size),
# the slice's CC path on the card, event time over sharded sockets, the
# multi-process kill sweep and the fabric legs of bench.py:run_transport_bench
IG_EDGES = 1 << 20  # 1 << 22 until phase northstar joined (PERF.md section 4)
IG_SCALE = 20
IG_SEED = 7
IG_WINDOW = 1 << 14  # per shard
IG_SUPERBATCH = 8
IG_FRAME_EDGES = 8192
IG_QUEUE_WINDOWS = 8
IG_CELLS = ((1, "text"), (2, "text"), (4, "text"), (1, "binary"), (2, "binary"),
            (4, "binary"))
IG_REPS = 3
IG_CC_CELLS = ((4, "binary"), (1, "text"))  # (b): the streams into CC
IG_ET_SHARDS = 2
IG_MP_WINDOWS = 6  # the reference's 12 cut to fit about 90 s; 6 is the
# least at which the corrupt point (window max(2 * every + 2, windows // 2))
# exists
IG_MP_SOCKET_WINDOWS = 1  # one kill point against the exchange daemon
IG_MP_DEVICE = "cuda"  # where the sweep's workers run their CC
IG_STORE_ROUNDS = 200
IG_AG_ROUNDS = 30
IG_ELECTIONS = 40

# phase 20 (serving): (a) bench.py:1704 bench_serving at its defaults
SV_VERTICES = 1 << 17
SV_WINDOW = 1 << 18
SV_WINDOWS = 8
SV_SEED = 23
SV_BURST = 256  # queries a burst (half ConnectedQuery, half ComponentSizeQuery in (b))
SV_PACE_S = 0.01
SV_MAX_PENDING = 1 << 15
SV_PAIRS = 2  # plain/served pairs after a warm pass of each (the reference's 3 cut)
# (a) at the defaults serves 0.1-0.8 s, 5-7 batches: its overhead and p99
# weigh the server's start. The steady run is the same bench over 16x the
# windows (2^25 edges), long enough to hold about a hundred batches
SV_STEADY_WINDOWS = 128  # 256 until phase northstar joined (PERF.md section 4)
SV_SHORT_WINDOWS = 4  # (b) the degree, rank and bipartiteness servables' windows
SV_DEVICE = "cuda"  # where the served tables live (and both replicas' in (c))
SV_STEP_REPS = 20  # calls of each query step between two CUDA events
SV_HOST_REPS = 5  # calls of each host-path form, numpy and torch on the CPU
# (c) run_rpc_scenario at the config of BENCH_SERVING_RPC_CPU.json
SV_RPC = dict(clients=4, batch=16, pace_s=0.005, kill_at_sweep=1500, lease_s=0.4,
              seed=4321, autotune=True)

# H100 SXM peaks (NVIDIA data sheet): HBM rate and dense bf16 tensor rate;
# float32 work counts against the CUDA cores' f32 rate
# phase 21: the routing tier (slice 9b)
RT_SEED = 23
RT_SHARDS = 2
RT_EX_WINDOW = 1 << 14  # per shard, phase 19's
RT_EX_EDGES = 1 << 22
RT_EX_VERTICES = 1 << 21  # the headline's id bound
RT_SH_VERTICES = 1 << 21  # halved with RT_SH_EDGES until c3's full pull fits a frame
RT_SH_EDGES = 1 << 22
RT_SH_WINDOW = 1 << 17
RT_SH_MEASURE_S = 0.5  # each load cell; SHARDED_DEFAULTS' 4.0 until phase 23 joined, 2.0
# until phase northstar joined
RT_STORM = dict(n_vertices=1 << 11, n_edges=1 << 12, phase_s=1.2, clients=2,
                oracle_checks=64)  # bench.py:3259-3262, --storm --smoke
RT_DEVICE = "cuda"  # where every shard replica's tables live

# phase 22: the mesh (slice 6) on one card
MESH_WIDTHS = (2, 4)  # the gloo worlds of (b), every rank on the one card
MESH_TABLE = CC_ID_BOUND  # the collectives' tables: CC's at the headline id bound
MESH_COLL_EDGES = 1 << 22  # the sharded segment ops' edge columns
MESH_COLL_REPS = 10
MESH_CC_EDGES = 1 << 22  # phase 5's corpus prefix: 4 windows of 2^20
MESH_BIP = (1 << 18, 1 << 20, 1 << 18, 25)  # vertices, edges, window, seed
MESH_TIMEOUT_S = 300  # a collective that waits longer fails the rank

# phase 23: training (slice 3) at config #5's width: phase 4's stream over
# its 4 windows (2^20 edges) on V = 2^16, DIMS in bf16, targets from a seed
TR_STEPS = 8  # each of SGD and Adam, remat off and on, in (a) and (b)
TR_TIMED = 5  # steps timed after a warm step
TR_MESH_STEPS = 3  # each of SGD and Adam on every mesh of (c)
TR_WORLD = 4  # the gloo world of (c), every rank on the one card
TR_MESHES = ((1, 2), (2, 1), (2, 2))  # edges x model, each on the world's first ranks
TR_LR = {"sage": 0.05, "gcn": 1.0}  # SGD; GCN's normalised outputs need the larger step
TR_ADAM_LR = 1e-2
TR_TARGET_SEED = 27
# the card's first-step gradients against autograd through the plain
# version on the card (GCN: the same step on the CPU), relative to the
# largest reference entry: both run in bf16 through two layers, each
# rounded to bf16, and the kernel's f32 sums run in another order
TR_GRAD_TOL = 2e-2
# a mesh run against the width-1 run: the partial sums all-reduce in bf16,
# another order than one scatter. Losses and SGD's parameters within
# TR_MESH_TOL of the width-1 values (parameters: of the largest); Adam
# divides each gradient by its own running scale, so a gradient near 0
# whose rounding differs can move its parameter by up to the learning rate
# the other way: Adam's parameters within 2 * lr a step more
TR_MESH_TOL = 2e-2

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

# kernel vs plain: f32 differs only by summation order; bf16 also by the
# one rounding of the output to bf16 (each relative to max|ref|)
KERNEL_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# end to end, bf16: index_add_ sums with atomics in an order that changes
# from run to run, in bf16, and both layers round to bf16
SLICE_TOL = 2e-2

# written before every timed launch: more than twice the H100's 50 MB L2
FLUSH_BYTES = 256 << 20
# a profiled pass: at most this many attempts to trace every counted launch
# of a ctypes kernel, each after a primer of this many small launches and
# with this idle time on the card before and after; the pass runs inside a
# range of this name, from whose start on the trace counts
PROFILE_ATTEMPTS = 3
PROFILE_PRIMER_LAUNCHES = 128
PROFILE_SETTLE_S = 0.05
PROFILE_MARK = "profile.pass"
TIMED_LAUNCHES = 25


def make_stream(n_vertices, n_edges, seed=7):
    """Power-law-ish random edge stream (Zipf endpoints, like social graphs);
    the generator of bench.py's config #5."""
    rng = np.random.default_rng(seed)
    u = rng.random(n_edges)
    v = rng.random(n_edges)
    a = 0.75  # skew
    src = np.minimum((n_vertices * u**a * rng.random(n_edges)).astype(np.int64), n_vertices - 1)
    dst = np.minimum((n_vertices * v**a * rng.random(n_edges)).astype(np.int64), n_vertices - 1)
    return src.astype(np.int32), dst.astype(np.int32)


def say(*parts):
    print(*parts, flush=True)


def cold_ms(torch, fn, flush, iters=TIMED_LAUNCHES, warmup=3, lead_cycles=0):
    """Median device time of one call of ``fn`` with a cold L2: before each
    call the ``flush`` buffer (``FLUSH_BYTES``) is written, which evicts the
    operands from L2, and each call runs between its own pair of CUDA
    events. The write of the buffer takes longer on the card than the host
    takes to enqueue the call, so the events time the call, not the host.
    A call that the host enqueues more slowly than that (many small
    launches) gets ``lead_cycles`` of a spinning kernel after the write."""
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        if lead_cycles:
            torch.cuda._sleep(lead_cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def cuda_ms(torch, fn, iters=20, warmup=3):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls on the
    same operands, by one pair of CUDA events (the first slice's timing;
    operands that fit in L2 stay warm there)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    say(smi)
    say(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} card(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    say("tf32 off for float32 matmuls (torch.backends.cuda.matmul.allow_tf32 = False)")
    return smi


def phase_build():
    from gelly_streaming_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    paths = cuda_build.build_all()
    say(f"build: {len(paths)} kernel source(s) in {time.perf_counter() - t0:.2f} s")
    for name in paths:
        info = cuda_build.BUILD_INFO[name]
        say(f"  {name}: nvcc {info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                say("   ", line.strip())
    sass_counts(paths["fused_sage_matmul"], cuda_build.find_nvcc())


def sass_counts(library, nvcc):
    """Counts of HGMMA (wgmma) and UTMALDG (TMA tile load) in each instance
    of the tensor-core kernel, from ``cuobjdump -sass`` of the built library;
    fails if an instance has none of either."""
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if not os.path.isfile(cuobjdump):
        cuobjdump = shutil.which("cuobjdump")
    if not cuobjdump:
        say("sass: HGMMA and UTMALDG not checked (no cuobjdump)")
        return
    sass = subprocess.run([cuobjdump, "-sass", library], capture_output=True, text=True,
                          check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            if "fused_sage_matmul_tc_kernel" not in fn:
                fn = None
            else:
                counts[fn] = {"HGMMA": 0, "UTMALDG": 0}
        elif fn is not None:
            for op in ("HGMMA", "UTMALDG"):
                counts[fn][op] += op in line
    if not counts:
        raise AssertionError("cuobjdump shows no fused_sage_matmul_tc_kernel")
    for fn, c in sorted(counts.items()):
        say(f"sass: {fn}: HGMMA {c['HGMMA']}, UTMALDG {c['UTMALDG']}")
        if c["HGMMA"] == 0 or c["UTMALDG"] == 0:
            raise AssertionError(f"the tensor-core kernel {fn} has no wgmma or no TMA load")


def _operands(torch, gen, v, f, o, dtype):
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    return rnd(v, f), rnd(v, f), rnd(f, o), rnd(f, o), rnd(o)


def bound_ms(v, f, o, dtype_name):
    """Least time on the card: each operand read once, the output written
    once, against the 4*V*F*O multiply-adds (plus bias) at peak."""
    size = 2 if dtype_name == "bfloat16" else 4
    nbytes = (2 * v * f + 2 * f * o + o + v * o) * size
    ops = 4 * v * f * o + v * o
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype_name]) * 1e3, nbytes, ops


def _check_kernel(torch, sk, ops, act, variant, label):
    """One wrapper call on the card, which must launch ``variant``, against
    the plain version at ``KERNEL_TOL``; returns the max abs error."""
    dtype_name = str(ops[0].dtype).replace("torch.", "")
    before = dict(sk.LAUNCHES_BY_VARIANT)
    got = sk.fused_sage_matmul(*ops, act)
    torch.cuda.synchronize()
    launched = {k: sk.LAUNCHES_BY_VARIANT[k] - before[k] for k in before}
    want = sk.fused_sage_matmul_plain(*ops, act)
    err = (got.float() - want.float()).abs().max().item()
    ref = want.float().abs().max().item()
    tol = KERNEL_TOL[dtype_name] * max(ref, 1.0)
    ok = (err <= tol and bool(torch.isfinite(got).all())
          and launched == {k: int(k == variant) for k in launched})
    say(f"kernel vs plain {label} {dtype_name} {act} [{variant}]: max_abs_err {err:.3e} "
        f"(max|ref| {ref:.3e}, tol {tol:.3e}) launched {launched} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"fused_sage_matmul ({variant}) failed at {label} {dtype_name} {act}")
    return err


def _misaligned(torch, t):
    """A contiguous copy of ``t`` whose address is 2 bytes past a multiple
    of 16 (an element into a fresh allocation)."""
    flat = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    view = flat[1:1 + t.numel()].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 == 2
    return view


def phase_kernels(torch):
    from gelly_streaming_tpu_torch.ops import sage_kernels as sk

    gen = torch.Generator(device="cuda").manual_seed(0)
    main = [(N_VERTICES, DIMS[0], DIMS[1]), (N_VERTICES, DIMS[1], DIMS[2])]
    main_err = 0.0
    # config #5 shapes: bf16 on the tensor cores, f32 on the CUDA cores
    for v, f, o in main:
        for dtype_name, variant in (("bfloat16", "tc"), ("float32", "simt")):
            ops = _operands(torch, gen, v, f, o, getattr(torch, dtype_name))
            for act in ("relu", "none"):
                err = _check_kernel(torch, sk, ops, act, variant, f"[{v},{f}]x[{f},{o}]")
                if variant == "tc":
                    main_err = max(main_err, err)
    # ragged tensor-core shapes: V and F tails, O > 256 (two column tiles)
    for f, o in ((48, 72), (136, 264)):
        for v in (1, 100, 257, 65537):
            ops = _operands(torch, gen, v, f, o, torch.bfloat16)
            for act in ("relu", "none"):
                _check_kernel(torch, sk, ops, act, "tc", f"[{v},{f}]x[{f},{o}]")
    # the CUDA-core kernel: f32, F and O off multiples of 8, misaligned bf16
    for v, f, o in ((100, 48, 72), (257, 130, 65), (1, 1, 1)):
        for dtype_name in ("float32", "bfloat16"):
            ops = _operands(torch, gen, v, f, o, getattr(torch, dtype_name))
            if dtype_name == "bfloat16" and f % 8 == 0 and o % 8 == 0:
                ops = tuple(_misaligned(torch, t) for t in ops)
            for act in ("relu", "none"):
                _check_kernel(torch, sk, ops, act, "simt", f"[{v},{f}]x[{f},{o}]")

    # times at the main path's shapes: layer 1 relu, layer 2 none, bf16
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    rows = []
    for (v, f, o), act in zip(main, ("relu", "none")):
        h, agg, ws, wn, b = _operands(torch, gen, v, f, o, torch.bfloat16)
        cat_x = torch.cat([h, agg], dim=1)
        cat_w = torch.cat([ws, wn], dim=0)
        out = torch.empty((v, o), dtype=torch.bfloat16, device="cuda")

        def kernel():
            return sk.fused_sage_matmul(h, agg, ws, wn, b, act)

        def simt():
            sk._launch("simt", h, agg, ws, wn, b, out, act)

        def plain():
            return sk.fused_sage_matmul_plain(h, agg, ws, wn, b, act)

        def library():
            y = torch.addmm(b, cat_x, cat_w)
            return torch.relu_(y) if act == "relu" else y

        row = {
            "shape": f"[{v},{f}]x[{f},{o}] {act}",
            "kernel_ms": cold_ms(torch, kernel, flush),
            "plain_ms": cold_ms(torch, plain, flush),
            "library_ms": cold_ms(torch, library, flush),
            "simt_ms": cold_ms(torch, simt, flush),
        }
        row["bound_ms"], row["bytes"], row["ops"] = bound_ms(v, f, o, "bfloat16")
        row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
        t0 = time.perf_counter()
        for _ in range(100):
            kernel()
        row["host_us_per_call"] = (time.perf_counter() - t0) * 1e4
        torch.cuda.synchronize()
        say("time (cold L2, median of each launch alone) " + json.dumps(row))
        if row["bound_share"] > 1.0:
            raise AssertionError("the kernel ran faster than its bound: the timing is wrong")
        warm = {"shape": row["shape"], "kernel_ms": cuda_ms(torch, kernel),
                "plain_ms": cuda_ms(torch, plain), "library_ms": cuda_ms(torch, library),
                "simt_ms": cuda_ms(torch, simt)}
        say("time (warm loop as in the first slice: mean of 20 back-to-back launches) "
            + json.dumps(warm))
        row["warm"] = warm
        rows.append(row)
    del flush
    return main_err, rows


def _run_slice(torch, src, dst, params, table, mesh=None):
    from gelly_streaming_tpu_torch import CountWindow, SimpleEdgeStream
    from gelly_streaming_tpu_torch.datasets import IdentityDict
    from gelly_streaming_tpu_torch.models import StreamingGraphSAGE

    stream = SimpleEdgeStream(
        (src, dst), window=CountWindow(WINDOW),
        vertex_dict=IdentityDict(N_VERTICES), device="cuda",
    )
    return list(StreamingGraphSAGE(params, feature_dim=DIMS[0], mesh=mesh).run(stream, table))


def phase_slice(torch, kernel_rows):
    from gelly_streaming_tpu_torch.models import graphsage
    from gelly_streaming_tpu_torch.models.graphsage import mean_aggregate
    from gelly_streaming_tpu_torch.ops import sage_aggregate as sa
    from gelly_streaming_tpu_torch.ops import sage_kernels as sk

    src, dst = make_stream(N_VERTICES, WINDOW * N_WINDOWS, seed=STREAM_SEED)
    params, table = _sage_params(torch)

    # the main path, counted: every window's layers go through the
    # tensor-core kernel, and every layer's mean is one launch of the mean
    # kernel that reads every held message
    layers = len(DIMS) - 1
    sk.LAUNCHES = 0
    sk.LAUNCHES_BY_VARIANT.update(tc=0, simt=0)
    sa.LAUNCHES = sa.MESSAGES_PULLED = 0
    aggregated = graphsage.MESSAGES_AGGREGATED
    outs = _run_slice(torch, src, dst, params, table)
    torch.cuda.synchronize()
    launches = sk.LAUNCHES
    by_variant = dict(sk.LAUNCHES_BY_VARIANT)
    mean_launches, pulled = sa.LAUNCHES, sa.MESSAGES_PULLED
    aggregated = graphsage.MESSAGES_AGGREGATED - aggregated
    say(f"slice: {len(outs)} windows, fused_sage_matmul launches {launches} {by_variant} "
        f"(expected tc {layers * N_WINDOWS}, simt 0); sage_segment_mean launches "
        f"{mean_launches} (expected {layers * N_WINDOWS}), messages pulled {pulled} of "
        f"{aggregated} aggregated")
    if len(outs) != N_WINDOWS or by_variant != {"tc": layers * N_WINDOWS, "simt": 0}:
        raise AssertionError("the main path did not launch the tensor-core kernel once "
                             "a layer, and only it")
    if mean_launches != layers * N_WINDOWS or pulled != aggregated or not pulled:
        raise AssertionError("the main path did not take every layer's mean with one "
                             "launch of the mean kernel over every held message")
    for out in outs:
        if tuple(out.shape) != (N_VERTICES, DIMS[-1]) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"bad embeddings: shape {tuple(out.shape)}")

    # reference on the card from the plain functions, over all 2^20 edges
    s = torch.from_numpy(src).to("cuda")
    d = torch.from_numpy(dst).to("cuda")
    mask = torch.ones(s.shape[0], dtype=torch.bool, device="cuda")
    h = table.table
    for i, p in enumerate(params):
        agg = mean_aggregate(h, s, d, mask, N_VERTICES)
        act = "relu" if i < len(params) - 1 else "none"
        h = sk.fused_sage_matmul_plain(h, agg, p["w_self"], p["w_nbr"], p["b"], act)
    diff = (outs[-1].float() - h.float()).abs()
    ref = h.float().abs().max().item()
    err = diff.max().item()
    say(f"slice vs plain-composed reference (last window, {src.shape[0]} edges): "
        f"max_abs_err {err:.3e}, mean_abs_err {diff.mean().item():.3e}, "
        f"max|ref| {ref:.3e}, tol {SLICE_TOL * ref:.3e}")
    if not err <= SLICE_TOL * ref:
        raise AssertionError("the slice's embeddings disagree with the reference")
    del outs, s, d, mask, h, agg, diff

    # steady passes after the warm one above: host clock around a whole
    # pass (windowing, uploads, forward), ended by a synchronize
    times = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        t0 = time.perf_counter()
        _run_slice(torch, src, dst, params, table)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    wall = statistics.median(times)
    ms_window = wall / N_WINDOWS * 1e3
    kernel_window_ms = sum(r["kernel_ms"] for r in kernel_rows)
    result = {
        "launches": launches,
        "mean_launches": mean_launches,
        "messages_pulled_share": pulled / aggregated,
        "edges_per_s": WINDOW * N_WINDOWS / wall,
        "ms_per_window": ms_window,
        "pass_s": times,
        "kernel_ms_per_window": kernel_window_ms,
        "kernel_share": kernel_window_ms / ms_window,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    say("slice " + json.dumps(result))
    profile_pass(torch, lambda: _run_slice(torch, src, dst, params, table), wall)
    return result


def _event_ms(torch, fn):
    """Device ms of one call of ``fn`` between two CUDA events, and its
    result."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def _workers_spanned(torch, sa, csr, row, f):
    """How many workers' runs of the last bfloat16 launch at width ``f``
    hold messages of ``row``: the kernel's merge-path split of its rows
    and messages into equal runs (``csrc/sage_aggregate.cu``), which at
    the cell's size takes every worker its scratch holds."""
    workers = next(w for (_, dtype, width), (w, _, _) in sa._SCRATCH.items()
                   if dtype == 0 and width == f)
    per = -(-(csr.n_rows + csr.n) // workers)
    start, end = int(csr.row_ptr[row]), int(csr.row_ptr[row + 1])
    # the row's messages lie at path items [row + start, row + end)
    return (row + end - 1) // per - (row + start) // per + 1


def phase_sage_aggregate(torch, smi=None, device="cuda"):
    """Phase 4b: the SAGE mean kernel at the sage_products_w8m cell's last
    window (module docstring). Returns the kernel's row."""
    from graphbench import generate

    from gelly_streaming_tpu_torch.models.graphsage import mean_aggregate
    from gelly_streaming_tpu_torch.ops import sage_aggregate as sa

    v = 1 << SA_SCALE
    src, dst = generate.rmat(SA_EDGES, SA_SCALE, *SA_RMAT, SA_SEED, device)
    csr = sa.MessageCSR(device=device)
    append_ms = []
    for a in range(0, SA_EDGES, SA_WINDOW):
        b = min(a + SA_WINDOW, SA_EDGES)
        ms, _ = _event_ms(torch, lambda: csr.append(src[a:b], dst[a:b], v))
        append_ms.append(ms)
    order = torch.sort(dst, stable=True).indices
    ok_csr = (torch.equal(csr.src[:SA_EDGES], src[order])
              and torch.equal(csr.dst[:SA_EDGES], dst[order]))
    counts = csr.row_ptr[1:] - csr.row_ptr[:-1]
    ok_csr = ok_csr and torch.equal(counts, torch.bincount(dst.long(), minlength=v))
    del order
    say(f"sage aggregate: CSR of {SA_EDGES} messages over {v} ids in {len(append_ms)} windows: "
        f"append ms {[round(x, 3) for x in append_ms]}, equal to a stable sort: {ok_csr}; "
        f"max in-degree {int(counts.max())}, "
        f"ids with none {float((counts == 0).double().mean()):.3f}")
    if not ok_csr:
        raise AssertionError("the carried CSR differs from a stable sort of the stream")
    hub = int(counts.argmax())
    rows = []
    gen = torch.Generator(device=device).manual_seed(SA_SEED)
    for f in SA_WIDTHS:
        h = torch.randn((v, f), generator=gen, device=device).to(torch.bfloat16)
        mean = lambda: sa.segment_mean(h, csr.src, csr.row_ptr, csr.n)  # noqa: E731
        launches = sa.LAUNCHES
        first = mean()
        again = mean()
        torch.cuda.synchronize()
        identical = torch.equal(first, again)
        times = [_event_ms(torch, mean)[0] for _ in range(SA_TIMED)]
        plain_ms, plain = _event_ms(
            torch, lambda: sa.segment_mean_plain(h, csr.src, csr.row_ptr, csr.n))
        # every element within one bfloat16 rounding at its row's largest
        # magnitude (the two roundings of nearly equal float32 means differ
        # by at most that), plus 2^-12 of it for the two float32 sums'
        # orders; the check must fail with the hub, which many workers'
        # runs cut, zeroed
        limit = plain.float().abs().amax(1, keepdim=True) * (2.0 ** -7 + 2.0 ** -12)

        def rows_off(out):
            return int(((out.float() - plain.float()).abs() > limit).any(1).sum())

        bad_rows = rows_off(first)
        cut = first.clone()
        cut[hub] = 0
        hub_caught = rows_off(cut) == 1
        del plain, limit, again, cut
        library_ms, _ = _event_ms(torch, lambda: mean_aggregate(h, src, dst, None, v))
        nbytes = SA_EDGES * (4 + 2 * f) + 2 * v * f
        ms = statistics.median(times)
        row = {"f": f, "ms": ms, "ms_all": times, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
               "bytes": nbytes, "plain_ms": plain_ms, "library_ms": library_ms,
               "bit_identical": identical, "rows_off_plain": bad_rows,
               "zeroed_hub_caught": hub_caught, "hub_in_degree": int(counts[hub]),
               "hub_workers": _workers_spanned(torch, sa, csr, hub, f),
               "launches": sa.LAUNCHES - launches}
        row["bound_share"] = row["bound_ms"] / ms
        say("sage aggregate " + json.dumps(row))
        if (not identical or bad_rows or not hub_caught or row["hub_workers"] < 2
                or not bool(torch.isfinite(first).all())):
            raise AssertionError(f"the mean kernel at F = {f} disagrees with itself or with "
                                 f"the plain version ({bad_rows} rows off), or the check "
                                 f"missed a zeroed hub ({hub_caught})")
        if row["bound_share"] > 1.0:
            raise AssertionError("the kernel ran faster than its bound: the timing is wrong")
        rows.append(row)
        del h, first
    # a window's three layers: F = 104, then 256 twice
    result = {"append_ms_last": append_ms[-1], "append_ms_max": max(append_ms), "rows": rows}
    for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
        result[f"{key}_window"] = sum(r[key] for r in rows) + rows[-1][key]
    result["per"] = (f"last window of sage_products_w8m: E = {SA_EDGES}, V = {v}, "
                     f"F = 104, 256, 256, bf16; {smi}")
    say("sage aggregate " + json.dumps({k: result[k] for k in result if k != "rows"}))
    del src, dst, csr
    torch.cuda.empty_cache()
    return result


def profile_pass(torch, one_pass, wall, prof=None, since=None):
    """Device time by kernel over one pass (torch.profiler): the busy share
    and the eight kernels that take the most device time (of ``prof`` when
    the pass was already profiled; of its device events from ``since``, in
    trace µs, on, where given)."""
    from torch.profiler import ProfilerActivity, profile

    if prof is None:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            one_pass()
            torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # (name, device µs, launches) of each kernel; the device-side copies of
    # the obs spans' record_function ranges are ranges, not kernels
    if since is None:
        kernels = [(e.key, dev_us(e), e.count) for e in prof.key_averages()
                   if e.device_type.name == "CUDA" and dev_us(e) > 0
                   and not e.key.startswith(SPAN_PREFIXES)]
    else:
        by_name = {}
        for e in prof.events():
            if (e.device_type.name == "CUDA" and e.time_range.start >= since
                    and not e.name.startswith(SPAN_PREFIXES)):
                us, n = by_name.get(e.name, (0.0, 0))
                by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
        kernels = [(name, us, n) for name, (us, n) in by_name.items() if us > 0]
    total_us = sum(us for _, us, _ in kernels)
    if total_us == 0:
        say("profile: no device time in the trace (not measured)")
        return None
    say(f"profile: device busy {total_us / 1e3:.3f} ms over a {wall * 1e3:.3f} ms pass "
        f"(busy share {total_us / 1e6 / wall:.3f}, not corrected for profiler overhead)")
    for name, us, n in sorted(kernels, key=lambda k: k[1], reverse=True)[:8]:
        say(f"  {us / total_us:6.3f}  {us / 1e3:9.3f} ms  x{n:<4d} {name[:90]}")
    return total_us / 1e6 / wall


def _rmat_chunk(start, n, scale, a, b, c, seed):
    """One chunk of :func:`rmat_columns`: ``n`` edges from the seed
    ``seed + start``, one pass of draws per address bit."""
    rng = np.random.default_rng(seed + start)
    src = np.zeros(n, np.int64)
    dst = np.zeros(n, np.int64)
    for _ in range(scale):
        r = rng.random(n)
        src = (src << 1) | (r >= a + b)
        dst = (dst << 1) | ((r >= a) & (r < a + b) | (r >= a + b + c))
    return src, dst


def rmat_columns(n_edges, scale, chunk=1 << 22, a=0.57, b=0.19, c=0.19, seed=0):
    """The surrogate's edge columns regenerated from the seeds the corpus
    writer uses (chunk ``start`` takes seed ``seed + start``), by an R-MAT
    written out here: the oracle needs neither the port nor the file. The
    chunks are made on a pool of threads (numpy's generator and its array
    operations release the interpreter lock) and joined in their order.
    One chunk with ``seed`` is the serve peer's stream (phase 19)."""
    from concurrent.futures import ThreadPoolExecutor

    starts = range(0, n_edges, chunk)
    with ThreadPoolExecutor(max(1, min(len(starts), os.cpu_count() or 1))) as pool:
        parts = list(pool.map(
            lambda s: _rmat_chunk(s, min(chunk, n_edges - s), scale, a, b, c, seed), starts))
    return np.concatenate([p[0] for p in parts]), np.concatenate([p[1] for p in parts])


@functools.lru_cache(maxsize=1)
def rmat_oracle_edges(n_edges, scale, chunk=1 << 22, a=0.57, b=0.19, c=0.19, seed=0):
    """:func:`rmat_columns`, kept for phase 6, which checks the same edges
    as phase 5; callers only read them."""
    return rmat_columns(n_edges, scale, chunk, a, b, c, seed)


def oracle_labels(src, dst, n):
    """Each vertex's least vertex id in its component, by scipy."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    graph = coo_matrix((np.ones(len(src), np.int8), (src, dst)), shape=(n, n))
    ncomp, comp = connected_components(graph, directed=True, connection="weak")
    least = np.full(ncomp, n, np.int64)
    np.minimum.at(least, comp, np.arange(n))
    return least[comp]


def _cc_pass(torch, path, carry="auto", superbatch=1, windows=None):
    """One pass of the headline cell as ``bench_cc_e2e`` runs it: returns
    the result dict and the emissions (only the last, unless ``windows``
    asks for the first few, which stops the stream there)."""
    from gelly_streaming_tpu_torch import CountWindow, datasets
    from gelly_streaming_tpu_torch.library import ConnectedComponents
    from gelly_streaming_tpu_torch.summaries import labels

    stream = datasets.stream_file(
        path, window=CountWindow(CC_WINDOW), vertex_dict=datasets.IdentityDict(CC_ID_BOUND),
        prefetch_depth=2, device="cuda",
    )
    agg = ConnectedComponents(carry=carry, superbatch=superbatch)
    labels.HOST_READS = labels.FIXPOINT_TURNS = 0
    kept, lat = [], []
    t0 = last_t = time.perf_counter()
    it = stream.aggregate(agg)
    for comps in it:
        now = time.perf_counter()
        lat.append(now - last_t)
        last_t = now
        kept = kept + [comps] if windows else [comps]
        if windows and len(kept) == windows:
            it.close()
            break
    agg.sync()
    dt = time.perf_counter() - t0
    lat_ms = np.asarray(lat) * 1e3
    n_win = len(lat)
    return {
        "windows": n_win,
        "seconds": dt,
        "p50_ms": float(np.percentile(lat_ms, 50)),
        "p95_ms": float(np.percentile(lat_ms, 95)),
        "carry": agg._cc_mode,
        "host_reads_per_window": labels.HOST_READS / n_win,
        "fixpoint_turns_per_window": labels.FIXPOINT_TURNS / n_win,
    }, kept, agg


class _SpanTotals:
    """An obs span sink: calls and host seconds by span name, over every
    thread (the prefetch producer's spans included)."""

    def __init__(self):
        import threading

        self.lock = threading.Lock()
        self.totals = {}

    def emit(self, event):
        with self.lock:
            row = self.totals.setdefault(event["name"], [0, 0.0])
            row[0] += 1
            row[1] += event["dur_s"]


def cc_step_bytes(t, t_group, n, v, k):
    """Bytes each CC device step must move for a window of ``n`` edges
    touching ``t`` vertices over a ``v``-vertex forest (``t_group`` touched
    by a group of ``k`` windows): each input read once, each output written
    once, int32 lanes, bool masks; the gathers read only the entries they
    need, and the commit copies the forest (read and write) since every
    emission keeps its own."""
    return {
        # tid, tmask, the chased forest entries; r, v2, key_ written
        "cc.chase_and_group": 21 * t,
        # lu, lv; the seed and the group targets; the local labels written
        "cc.propagate": 8 * n + 16 * t,
        # the forest read and its new copy written; local, key_, r, tid, tmask
        "cc.commit_roots": 8 * v + 17 * t,
        # per window of the group: lu, lv, the label table in and out, key_,
        # nr_k written; a k-th of the group's chase and commit
        "cc.forest_superbatch": 8 * n + 20 * t_group + (38 * t_group + 8 * v) / k,
        # the forest read once, the flat labels written
        "cc.resolve_flat": 8 * v,
        # the forest read and its new copy written; at least t (index, value)
        "cc.mirror_update": 8 * v + 12 * t,
    }


def _step_table(prof, names, per, since=None):
    """Device time and kernel launches under each named range (the CPU-side
    ``record_function`` events of the trace, from ``since`` on where
    given), divided by ``per``."""
    out = {}

    def kernels(e):
        return (len(e.kernels), sum(k.duration for k in e.kernels)), e.cpu_children

    for e in prof.events():
        if e.name not in names or e.device_type.name != "CPU":
            continue
        if since is not None and e.time_range.start < since:
            continue
        n = dur = 0
        stack = [e]
        while stack:
            (kn, kd), children = kernels(stack.pop())
            n += kn
            dur += kd
            stack.extend(children)
        row = out.setdefault(e.name, {"calls": 0, "launches": 0, "device_ms": 0.0})
        row["calls"] += 1
        row["launches"] += n
        row["device_ms"] += dur / 1e3
    return {k: {f: v / per for f, v in row.items()} for k, row in out.items()}


def phase_cc(torch):
    from gelly_streaming_tpu_torch import datasets, native
    from gelly_streaming_tpu_torch.obs import trace
    from gelly_streaming_tpu_torch.ops import sage_kernels as sk
    from gelly_streaming_tpu_torch.summaries import forest

    t0 = time.perf_counter()
    path, is_real = datasets.ensure_corpus(CC_CORPUS)
    spec = datasets.CORPORA[CC_CORPUS]
    say(f"cc corpus: {path} ({'real' if is_real else 'surrogate'}), "
        f"{os.path.getsize(path)} bytes, ready in {time.perf_counter() - t0:.2f} s")
    if is_real:
        raise AssertionError("the headline cell is the surrogate; a real corpus was found")
    n_edges = spec.surrogate_edges
    if not native.native_available():
        raise AssertionError(f"the native library did not load: {native.BUILD_ERROR}")
    say(f"cc native library: {native.library_path()}")

    # the timed cell: one warm pass, then the median of the steady passes;
    # the counts of every kernel are 0 just before and read just after
    sk.LAUNCHES = 0
    warm, _, _ = _cc_pass(torch, path)
    passes = [_cc_pass(torch, path) for _ in range(CC_STEADY_PASSES)]
    say(f"cc fused_sage_matmul launches in the CC passes: {sk.LAUNCHES} (the path has no "
        "hand-written kernel; its device steps are PyTorch operations)")
    results = [p[0] for p in passes]
    for r in results:
        r["edges_per_s"] = n_edges / r["seconds"]
    order = sorted(range(len(results)), key=lambda i: results[i]["edges_per_s"])
    mid = order[len(order) // 2]
    cell = dict(results[mid])
    cell["edges_per_s_all"] = [r["edges_per_s"] for r in results]
    cell["warm_seconds"] = warm["seconds"]
    cell["corpus_edges"] = n_edges
    say("cc cell " + json.dumps(cell))
    if cell["carry"] != "forest" or cell["windows"] != n_edges // CC_WINDOW:
        raise AssertionError(f"the cell ran carry {cell['carry']} over {cell['windows']} windows")

    # correctness: the last window against scipy on the regenerated edges
    last = passes[mid][1][-1]
    t1 = time.perf_counter()
    src, dst = rmat_oracle_edges(n_edges, int(spec.surrogate_vscale).bit_length() - 1)
    want = oracle_labels(src, dst, CC_ID_BOUND)
    seen = np.zeros(CC_ID_BOUND, bool)
    seen[src] = True
    seen[dst] = True
    ids, got = last.labels()
    want_ids = np.nonzero(seen)[0]
    n_comp = len(np.unique(got))
    ok = (np.array_equal(ids, want_ids) and np.array_equal(got, want[want_ids])
          and n_comp == len(np.unique(want[want_ids])))
    say(f"cc vs scipy (last window, {len(ids)} vertices seen): components {n_comp}, "
        f"mismatches {int(np.sum(got != want[want_ids])) if len(ids) == len(want_ids) else 'n/a'}, "
        f"{'exact' if ok else 'FAIL'} ({time.perf_counter() - t1:.1f} s)")
    if not ok:
        raise AssertionError("the forest carry disagrees with scipy's components")
    cell["components"] = n_comp
    cell["vertices_seen"] = int(len(ids))
    oracle = {"ids": ids, "labels": got}  # equal to scipy's, checked above
    # touched vertices per window and per group of the prefix: the sizes
    # the device steps' bounds are counted from
    touched = [np.unique(np.concatenate([src[a:a + CC_WINDOW], dst[a:a + CC_WINDOW]])).size
               for a in range(0, n_edges, CC_WINDOW)]
    prefix = CC_WINDOW * CC_PREFIX_WINDOWS
    t_group = np.unique(np.concatenate([src[:prefix], dst[:prefix]])).size
    cell["touched_per_window"] = float(np.mean(touched))
    cell["touched_prefix_group"] = int(t_group)
    say(f"cc touched vertices per window: mean {np.mean(touched):.0f}, min {min(touched)}, "
        f"max {max(touched)}; the first {CC_PREFIX_WINDOWS} windows together {t_group}")
    del src, dst, want, seen, passes

    # the other carries and the superbatch on the first windows
    base = [c.labels() for c in _cc_pass(torch, path, windows=CC_PREFIX_WINDOWS)[1]]
    for carry, k in (("host", 1), ("dense", 1), ("forest", CC_PREFIX_WINDOWS)):
        r, ems, _ = _cc_pass(torch, path, carry=carry, superbatch=k, windows=CC_PREFIX_WINDOWS)
        same = len(ems) == len(base) and all(
            np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
            for a, b in zip(base, (c.labels() for c in ems))
        )
        say(f"cc prefix {CC_PREFIX_WINDOWS} windows, carry {r['carry']} superbatch {k}: "
            f"{r['seconds'] * 1e3 / r['windows']:.1f} ms a window, "
            f"{'equal to the forest carry' if same else 'FAIL'}")
        if not same or r["carry"] != carry:
            raise AssertionError(f"carry {carry} (superbatch {k}) disagrees with the forest carry")

    # host time by span over one pass (no profiler): every thread's spans
    sink = _SpanTotals()
    trace.add_sink(sink)
    trace.enable()
    try:
        r, _, _ = _cc_pass(torch, path)
    finally:
        trace.disable()
        trace.remove_sink(sink)
    host = {name: {"calls": c / r["windows"], "host_ms": sec * 1e3 / r["windows"]}
            for name, (c, sec) in sorted(sink.totals.items())}
    say(f"cc host time per window by span (a pass of {r['seconds'] * 1e3:.1f} ms, "
        f"{r['seconds'] * 1e3 / r['windows']:.2f} ms a window; ingest.parse and window.pack "
        "run on the prefetch thread) " + json.dumps(host))
    cell["host_spans"] = host

    # where the time goes: one profiled pass, then the other steps
    from torch.profiler import ProfilerActivity, profile

    trace.enable(torch_annotations=True)
    try:
        torch.cuda.reset_peak_memory_stats()
        t2 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            r, ems, agg = _cc_pass(torch, path)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t2
        cell["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        profile_pass(torch, lambda: None, wall, prof=prof)
        steps = _step_table(prof, CC_STEPS, r["windows"])
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof2:
            forest.resolve_flat(agg._canon)
            _cc_pass(torch, path, carry="host", windows=CC_PREFIX_WINDOWS)
            _cc_pass(torch, path, superbatch=CC_PREFIX_WINDOWS, windows=CC_PREFIX_WINDOWS)
            torch.cuda.synchronize()
        others = _step_table(prof2, ("cc.resolve_flat", "cc.mirror_update",
                                     "cc.forest_superbatch"), CC_PREFIX_WINDOWS)
        others["cc.resolve_flat"] = {f: v * CC_PREFIX_WINDOWS
                                     for f, v in others.get("cc.resolve_flat", {}).items()}
    finally:
        trace.disable()
    say(f"cc peak device memory over a pass: {cell['peak_mem_gb']:.3f} GB")
    table = {**steps, **others}
    nbytes = cc_step_bytes(cell["touched_per_window"], t_group, CC_WINDOW, CC_ID_BOUND,
                           CC_PREFIX_WINDOWS)
    for name, row in table.items():
        if name in nbytes:
            row["bytes"] = nbytes[name]
            row["bound_ms"] = nbytes[name] / HBM_BYTES_PER_S * 1e3
            row["bound_share"] = row["bound_ms"] / row["device_ms"] if row["device_ms"] else None
    say("cc steps (device ms and launches per window of the forest pass; resolve_flat per "
        "call; mirror_update and forest_superbatch per window of the 4-window prefix; "
        "bound by bytes) " + json.dumps(table))
    cell["steps"] = table
    return cell, oracle


# --------------------------------------------------------------------- #
# The north-star shape (phase northstar)
# --------------------------------------------------------------------- #
def _host_peak_gb():
    """The process's peak resident size so far (``ru_maxrss``), in GB."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9


def _host_cpu():
    """The host CPU (both baselines run there): its model name where
    ``/proc/cpuinfo`` gives one, else its vendor, family and model
    numbers, and the core count."""
    import platform

    fields = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            key, _, value = line.partition(":")
            fields.setdefault(key.strip(), value.strip())
    model = fields.get("model name", "unknown")
    name = (model if model != "unknown" else "") or " ".join(
        f"{k} {fields[k]}" for k in ("vendor_id", "cpu family", "model", "CPU part")
        if fields.get(k)) or platform.processor() or platform.machine()
    return f"{name}, {os.cpu_count()} cores"


def _ns_pass(torch, bin_path, window, identity, prefetch=2):
    """One pass of ``bench_cc_e2e`` (``identity``: ``IdentityDict(1 << 23)``)
    or ``bench_cc_e2e_device`` (device encode) over the north-star binary
    corpus into ``ConnectedComponents()``, ``sync()`` inside the timed
    region; the peak of device memory is reset before it, the process's
    peak resident size read after. Returns the result, the last emission and the stream."""
    from gelly_streaming_tpu_torch import CountWindow, datasets
    from gelly_streaming_tpu_torch.library import ConnectedComponents
    from gelly_streaming_tpu_torch.ops import device_dict
    from gelly_streaming_tpu_torch.summaries import labels

    torch.cuda.reset_peak_memory_stats()
    if identity:
        stream = datasets.stream_file(
            bin_path, window=CountWindow(window), vertex_dict=datasets.IdentityDict(NS_ID_BOUND),
            prefetch_depth=prefetch, device=NS_DEVICE)
    else:
        stream = datasets.stream_file(
            bin_path, window=CountWindow(window), device_encode=True,
            min_vertex_capacity=NS_ID_BOUND, prefetch_depth=prefetch, device=NS_DEVICE)
    agg = ConnectedComponents()
    labels.HOST_READS = 0
    device_dict.ENCODES = 0
    lat, last = [], None
    t0 = last_t = time.perf_counter()
    for last in stream.aggregate(agg):
        now = time.perf_counter()
        lat.append(now - last_t)
        last_t = now
    agg.sync()
    dt = time.perf_counter() - t0
    lat_ms = np.asarray(lat) * 1e3
    return {
        "windows": len(lat), "seconds": dt,
        "p50_ms": float(np.percentile(lat_ms, 50)), "p95_ms": float(np.percentile(lat_ms, 95)),
        "carry": agg._cc_mode, "encodes": device_dict.ENCODES,
        "host_reads_per_window": labels.HOST_READS / len(lat),
        "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
        "process_peak_host_gb": _host_peak_gb(),
    }, last, stream


def _raw_partition(last, vdict, want, seen):
    """The emission's partition decoded to raw ids against scipy's
    (``want``: each vertex's least raw id in its component; ``seen``: the
    raw ids seen, ascending): whether the seen ids are equal, the ids whose
    component's least raw id differs, and the number of components."""
    ids, lab = last.labels()
    raw = vdict.decode(ids)
    uniq, inv = np.unique(lab, return_inverse=True)
    least = np.full(len(uniq), np.iinfo(np.int64).max, np.int64)
    np.minimum.at(least, inv, raw)
    order = np.argsort(raw)
    same = np.array_equal(raw[order], seen)
    bad = int(np.count_nonzero(least[inv][order] != want[seen])) if same else len(seen)
    return same, bad, len(uniq)


def phase_northstar(torch, smi=None):
    """``bench.py:2566 run_northstar`` on the card: the ``livejournal-xl``
    surrogate (R-MAT scale 23, 2^27 edges) in 2^20-edge windows, device
    encoded and through ``IdentityDict``, and in one window of 2^27 edges,
    each pass exact against scipy and its component count equal to the
    compiled baseline's. Alone: ``python3 -c "import chip_smoke, torch;
    chip_smoke.phase_northstar(torch)"`` (``smi`` is then read by
    :func:`phase_device`)."""
    import gc

    from gelly_streaming_tpu_torch import datasets, native

    if smi is None:
        smi = phase_device(torch)
    spec = datasets.CORPORA[NS_CORPUS]
    n_edges = spec.surrogate_edges
    scale = int(spec.surrogate_vscale).bit_length() - 1
    big = max(n_edges, NS_BIG_WINDOW)
    if not native.native_available():
        raise AssertionError(f"the native library did not load: {native.BUILD_ERROR}")
    cpu = _host_cpu()

    # (a) the corpus: the surrogate's columns from the seeds synthesize
    # uses, written as its binary cache (run_northstar's passes read only it)
    t0 = time.perf_counter()
    src, dst = rmat_columns(n_edges, scale)
    t_cols = time.perf_counter() - t0
    _cache_dir()
    bin_path = datasets.write_binary(datasets.surrogate_path(NS_CORPUS) + ".gbin", src, dst)
    t_make = time.perf_counter() - t0
    top = int(max(src.max(), dst.max()))
    say(f"northstar corpus: {bin_path}, {n_edges} edges, ids below {1 << scale} (largest {top}), "
        f"{os.path.getsize(bin_path)} bytes, made in {t_make:.1f} s (columns {t_cols:.1f} s, "
        f"write {t_make - t_cols:.1f} s)")
    if top >= NS_ID_BOUND:
        raise AssertionError(f"a corpus id {top} is not below {NS_ID_BOUND}")

    # (b) scipy's labels once; the compiled baseline and the Flink proxy
    # once each on the file's columns (the reference: the median of 3)
    t1 = time.perf_counter()
    want = oracle_labels(src, dst, NS_ID_BOUND)
    seen_mask = np.zeros(NS_ID_BOUND, bool)
    seen_mask[src] = True
    seen_mask[dst] = True
    seen = np.flatnonzero(seen_mask)
    del seen_mask
    n_comp = len(np.unique(want[seen]))
    say(f"northstar oracle: scipy over {NS_ID_BOUND} ids, {len(seen)} seen, {n_comp} components "
        f"({time.perf_counter() - t1:.1f} s)")
    t2 = time.perf_counter()
    chunks = list(datasets.iter_binary_chunks(bin_path, 1 << 22))
    s64 = np.concatenate([c[0] for c in chunks]).astype(np.int64)
    d64 = np.concatenate([c[1] for c in chunks]).astype(np.int64)
    del chunks
    load_s = time.perf_counter() - t2
    if not (np.array_equal(s64, src) and np.array_equal(d64, dst)):
        raise AssertionError("the binary corpus does not hold the generated columns")
    del src, dst
    cc_s, base_comp = native.cc_baseline(s64, d64, window=NS_WINDOW)
    fl_s, fl_comp = native.flink_proxy(s64, d64, window=NS_WINDOW)
    del s64, d64
    base = {"edges_per_s": n_edges / (load_s + cc_s), "load_s": load_s, "cc_s": cc_s,
            "components": base_comp}
    flink = {"edges_per_s": n_edges / fl_s, "cc_s": fl_s, "components": fl_comp}
    say(f"northstar baselines on the host [{cpu}]: compiled " + json.dumps(base)
        + "; flink proxy " + json.dumps(flink))
    if base_comp != n_comp or fl_comp != n_comp:
        raise AssertionError(f"components: baseline {base_comp}, flink proxy {fl_comp}, "
                             f"scipy {n_comp}")

    # (c)-(e) the three passes: one warm pass, then the median of NS_PASSES
    # (NS_IDENTITY_PASSES for the identity pass)
    cells = {}
    for name, window, identity, passes in (("window_1m", NS_WINDOW, False, NS_PASSES),
                                           ("window_1m_identity", NS_WINDOW, True,
                                            NS_IDENTITY_PASSES),
                                           ("window_100m", big, False, NS_PASSES)):
        warm, _, _ = _ns_pass(torch, bin_path, window, identity)
        runs = [_ns_pass(torch, bin_path, window, identity) for _ in range(passes)]
        results = [r[0] for r in runs]
        for r in results:
            r["edges_per_s"] = n_edges / r["seconds"]
        order = sorted(range(len(results)), key=lambda i: results[i]["edges_per_s"])
        mid = order[len(order) // 2]
        cell = dict(results[mid])
        cell.update(edges_per_s_all=[r["edges_per_s"] for r in results],
                    warm_seconds=warm["seconds"], window=window,
                    vs_baseline=cell["edges_per_s"] / base["edges_per_s"],
                    vs_flink=cell["edges_per_s"] / flink["edges_per_s"])
        t3 = time.perf_counter()
        same, bad, comps = _raw_partition(runs[mid][1], runs[mid][2].vertex_dict, want, seen)
        cell.update(vertices_seen=len(seen), mismatches=bad, components=comps)
        say(f"northstar {name} [{smi}] " + json.dumps(cell))
        say(f"northstar {name} vs scipy (last window, {len(seen)} vertices): seen ids "
            f"{'equal' if same else 'DIFFER'}, {bad} mismatches, components {comps} (baseline "
            f"{base_comp}) ({time.perf_counter() - t3:.1f} s); vs_baseline "
            f"{cell['vs_baseline']:.3f}, vs_flink {cell['vs_flink']:.3f} [card {smi}; baselines "
            f"on {cpu}]")
        want_windows = -(-n_edges // window)
        if not same or bad or comps != base_comp:
            raise AssertionError(f"northstar {name} disagrees with scipy or the baseline")
        if cell["windows"] != want_windows or (identity and cell["carry"] != "forest"):
            raise AssertionError(f"northstar {name} ran {cell['windows']} windows, carry "
                                 f"{cell['carry']}")
        cells[name] = cell
        del runs, results

    # where the time goes in the one-window pass (no prefetch: the encode's
    # ranges are then on the profiled thread)
    cells["window_100m"]["profile"] = profile_cell(
        torch, "northstar window_100m",
        lambda: _ns_pass(torch, bin_path, big, False, prefetch=0)[0]["windows"], DE_STEPS,
        {"dict.encode": dict_encode_bytes(n_edges, NS_ID_BOUND)})

    # free the corpus and the oracle before the later phases
    del want, seen
    os.remove(bin_path)
    gc.collect()
    torch.cuda.empty_cache()
    keys = ("windows", "carry", "edges_per_s", "p50_ms", "p95_ms", "mismatches", "components",
            "vs_baseline", "vs_flink", "peak_device_gb")
    summary = {"corpus_edges": n_edges, "components": n_comp, "cpu": cpu, "card": smi,
               "baseline_edges_per_s": base["edges_per_s"],
               "flink_edges_per_s": flink["edges_per_s"],
               **{name: {k: cell[k] for k in keys} for name, cell in cells.items()}}
    say("northstar result " + json.dumps(summary))
    return {"baseline": base, "flink": flink, **summary, **cells}


# --------------------------------------------------------------------- #
# The window and neighborhood layer (phases 6-9)
# --------------------------------------------------------------------- #
def _n_syncs(log):
    # the text of c10's warn_or_error_on_sync (set_sync_debug_mode's own
    # "prototype feature" notice is not a sync)
    return sum("called a synchronizing CUDA operation" in str(w.message) for w in log)


def count_syncs(torch, items):
    """Drain ``items`` (one per window) under
    ``torch.cuda.set_sync_debug_mode("warn")``: PyTorch then warns at every
    implicit host sync (a device-to-host read, a stream wait). Returns
    (windows, syncs up to the last window's item, syncs after it)."""
    with warnings.catch_warnings(record=True) as log:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            n = in_loop = 0
            for _ in items:
                n += 1
                in_loop = _n_syncs(log)
            after = _n_syncs(log) - in_loop
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return n, in_loop, after


def timed_passes(torch, one_pass, n_edges):
    """One warm pass, then ``STEADY_PASSES``: the host clock around each
    pass, which ends in a synchronize. Returns the cell's dict (the
    median pass) and its windows."""
    one_pass()
    times, windows = [], 0
    for _ in range(STEADY_PASSES):
        t0 = time.perf_counter()
        windows = one_pass()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    return {"windows": windows, "edges_per_s": n_edges / med, "ms_per_window": med / windows * 1e3,
            "edges_per_s_all": [n_edges / t for t in times], "pass_s": times}


def window_step_bytes(n, v, d=0):
    """Bytes each step of phases 6 and 7 must move for a window of ``n``
    edges over ``v`` vertices (rows ``d`` wide): each input read once, each
    output written once; int32 ids, bool masks."""
    return {
        # src, dst, mask, the degree vector in; the new vector and the
        # packed [2, 2n] ids and degrees out
        "degree.update": 9 * n + 8 * v + 16 * n,
        # ids and mask in, the counts out (per call)
        "segment.count": 5 * n + 4 * v,
        # ids, mask and the int32 payloads in and out (one payload: 13 n)
        "segment.sort": 2 * 13 * n,
        # key, nbr, val, mask in; the sorted four, row_ptr and degree out
        "csr.build": 26 * n + 8 * v,
        # src, dst, mask in; a, b, m and the sorted [v, d] rows out
        "tri.oriented_rows": 9 * n + 9 * n + 4 * v * d,
        # the rows, a, b, m in; the per-vertex counts and the total out
        "tri.membership": 4 * v * d + 9 * n + 4 * v,
    }


def step_rows(prof, names, per, nbytes, since=None):
    table = _step_table(prof, names, per, since)
    for name, row in table.items():
        if name in nbytes:
            row["bound_ms"] = nbytes[name] / HBM_BYTES_PER_S * 1e3
            row["bound_share"] = row["bound_ms"] / row["device_ms"] if row["device_ms"] else None
    return table


def _foreign_launches(foreign):
    """Each step of ``foreign`` -> its wrapper's launch count now."""
    import importlib

    return {step: importlib.import_module(f"gelly_streaming_tpu_torch.ops.{module}").LAUNCHES
            for step, (_, module) in foreign.items()}


def _captured_kernels(prof, foreign, since=None):
    """Each step of ``foreign`` (step -> (kernel name, wrapper module)) ->
    the launches of that kernel in the trace (from ``since`` on where
    given) and their device µs: a kernel launched through ctypes has no
    PyTorch operation, so no range holds it in ``_step_table``."""
    out = {}
    for step, (kernel, _) in foreign.items():
        n = us = 0
        for e in prof.events():
            if (e.device_type.name == "CUDA" and kernel in e.name
                    and (since is None or e.time_range.start >= since)):
                n += 1
                us += e.time_range.elapsed_us()
        out[step] = (n, us)
    return out


def _add_foreign_kernels(table, foreign, captured, per):
    """Add each foreign kernel's captured launches and device time,
    divided by ``per``, to its step's row."""
    for step, (kernel, _) in foreign.items():
        n, us = captured[step]
        row = table.setdefault(step, {"calls": 0.0, "launches": 0.0, "device_ms": 0.0})
        row["launches"] += n / per
        row["device_ms"] += us / 1e3 / per
        row[f"{kernel}_ms"] = us / 1e3 / per
        if "bound_ms" in row:
            row["bound_share"] = row["bound_ms"] / row["device_ms"] if row["device_ms"] else None


def profile_cell(torch, label, one_pass, names, nbytes, foreign=None):
    """One profiled pass with the device steps as record_function ranges:
    busy share, top operations, device-to-host copies, peak memory and
    the per-window step table (with the ``foreign`` kernels added, see
    ``_add_foreign_kernels``). The trace must hold every launch that the
    foreign kernels' wrappers counted in the pass; the pass is profiled
    again (up to ``PROFILE_ATTEMPTS`` times) where it does not, and if no
    attempt does, the busy share and the steps' device numbers are not
    measured (None)."""
    from torch.profiler import ProfilerActivity, profile

    from gelly_streaming_tpu_torch.obs import trace

    foreign = foreign or {}
    # host time by span over one pass (every thread's spans)
    sink = _SpanTotals()
    trace.add_sink(sink)
    trace.enable()
    try:
        windows = one_pass()
    finally:
        trace.disable()
        trace.remove_sink(sink)
    host = {name: {"calls": c / windows, "host_ms": sec * 1e3 / windows}
            for name, (c, sec) in sorted(sink.totals.items())}
    say(f"{label} host time per window by span " + json.dumps(host))
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        before = _foreign_launches(foreign)
        trace.enable(torch_annotations=True)
        try:
            torch.cuda.reset_peak_memory_stats()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                # a trace can lose its first device records (the first two
                # of config #4's four windows in some runs): a primer of
                # small launches goes first, and only the events from the
                # pass's mark on count (the ranges' from its start, the
                # device's from the middle of the idle gap before it); the
                # clock starts inside, after the card is idle, so the
                # profiler's own start-up is not part of the pass
                primer = torch.zeros(1, device="cuda")
                for _ in range(PROFILE_PRIMER_LAUNCHES):
                    primer.add_(1)
                torch.cuda.synchronize()
                time.sleep(PROFILE_SETTLE_S)
                with torch.profiler.record_function(PROFILE_MARK):
                    t0 = time.perf_counter()
                    windows = one_pass()
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                time.sleep(PROFILE_SETTLE_S)
        finally:
            trace.disable()
        since = min(e.time_range.start for e in prof.events()
                    if e.name == PROFILE_MARK and e.device_type.name == "CPU")
        # device timestamps can sit some ms off the host's clock in the
        # trace: device events count from the middle of the idle gap
        device_since = since - PROFILE_SETTLE_S * 1e6 / 2
        counted = {step: n - before[step] for step, n in _foreign_launches(foreign).items()}
        captured = _captured_kernels(prof, foreign, device_since)
        complete = all(captured[step][0] == n for step, n in counted.items())
        if complete:
            break
        held = {step: c[0] for step, c in captured.items()}
        say(f"{label} profile attempt {attempt}: the trace holds {held} of the launches the "
            f"wrappers counted, {counted}")
    say(f"{label} profile ({windows} windows):")
    busy = profile_pass(torch, lambda: None, wall, prof=prof, since=device_since)
    d2h = sum(1 for e in prof.events() if e.device_type.name == "CUDA" and "DtoH" in e.name
              and e.time_range.start >= device_since)
    peak = torch.cuda.max_memory_allocated() / 1e9
    table = step_rows(prof, names, windows, nbytes, since)
    _add_foreign_kernels(table, foreign, captured, windows)
    if not complete:
        say(f"{label} profile: the trace lost launches in {PROFILE_ATTEMPTS} attempts; its busy "
            f"share and device times are not measured")
        busy = None
        for row in table.values():
            for key in list(row):
                if key != "calls" and key != "bound_ms":
                    row[key] = None
    say(f"{label} device-to-host copies in the profiled pass: {d2h}; peak device memory "
        f"{peak:.3f} GB")
    say(f"{label} steps (device ms, launches and bytes' bound per window) " + json.dumps(table))
    return {"busy_share": busy, "d2h_copies": d2h, "peak_mem_gb": peak, "steps": table,
            "host_spans": host, "trace_complete": complete, "profile_attempts": attempt}


def _deg_batches(bin_path):
    from gelly_streaming_tpu_torch import CountWindow, datasets

    stream = datasets.stream_file(
        bin_path, window=CountWindow(CC_WINDOW), vertex_dict=datasets.IdentityDict(CC_ID_BOUND),
        prefetch_depth=2, device="cuda",
    )
    return stream.get_degrees().batches()


def _dd_events():
    rng = np.random.default_rng(DD_SEED)
    s = rng.integers(0, DD_VERTICES, DD_EVENTS).tolist()
    d = rng.integers(0, DD_VERTICES, DD_EVENTS).tolist()
    kinds = (rng.random(DD_EVENTS) < 0.7).tolist()
    return [(a, b, "+" if k else "-") for a, b, k in zip(s, d, kinds)]


def phase_degrees(torch):
    from gelly_streaming_tpu_torch import CountWindow, datasets
    from gelly_streaming_tpu_torch.library import DegreeDistribution

    path, _ = datasets.ensure_corpus(CC_CORPUS)
    spec = datasets.CORPORA[CC_CORPUS]
    n_edges = spec.surrogate_edges
    t0 = time.perf_counter()
    bin_path = datasets.binary_cache(path)
    say(f"degrees: binary cache {bin_path} ({os.path.getsize(bin_path)} bytes) in "
        f"{time.perf_counter() - t0:.2f} s")

    def one_pass():
        return sum(1 for _ in _deg_batches(bin_path))

    cell = timed_passes(torch, one_pass, n_edges)
    n, in_loop, after = count_syncs(torch, _deg_batches(bin_path))
    cell.update(host_syncs_in_loop=in_loop, host_syncs_per_window=in_loop / n,
                host_syncs_after_loop=after)
    say("degrees cell " + json.dumps(cell))
    if cell["windows"] != n_edges // CC_WINDOW or in_loop != 0:
        raise AssertionError(f"the degree loop ran {cell['windows']} windows with {in_loop} "
                             "host syncs")

    # correctness: every window's emission read, against numpy
    cols = [b.columns for b in _deg_batches(bin_path)]
    src, dst = rmat_oracle_edges(n_edges, int(spec.surrogate_vscale).bit_length() - 1)
    want = np.bincount(src, minlength=CC_ID_BOUND) + np.bincount(dst, minlength=CC_ID_BOUND)
    final = np.zeros(CC_ID_BOUND, np.int64)
    for ids, degs in cols:
        final[ids] = degs
    last_ids = np.unique(np.concatenate([src[-CC_WINDOW:], dst[-CC_WINDOW:]]))
    ok = (np.array_equal(final, want) and np.array_equal(cols[-1][0], last_ids)
          and np.array_equal(cols[-1][1], want[last_ids]) and cols[-1][1].dtype == np.int32)
    say(f"degrees vs numpy: {int((final > 0).sum())} vertices, max degree {int(want.max())}, "
        f"last window {len(last_ids)} changed vertices: {'exact' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the degree stream disagrees with np.bincount")

    # the fully dynamic workload: the card against the CPU
    events = _dd_events()
    out = {}
    for device in ("cpu", "cuda"):
        dd = DegreeDistribution(CountWindow(DD_WINDOW), device=device)
        t1 = time.perf_counter()
        emitted = [list(b) for b in dd.run(events)]
        out[device] = (emitted, dd.histogram(), dd.degrees(), time.perf_counter() - t1)
    (ce, ch, cd, cs), (ge, gh, gd, gs) = out["cpu"], out["cuda"]
    ok = ge == ce and gh == ch and np.array_equal(gd, cd)
    say(f"degree distribution, {DD_EVENTS} events in {len(ge)} windows: card {gs:.2f} s, cpu "
        f"{cs:.2f} s, {len(gh)} histogram bins, {'equal' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("DegreeDistribution on the card disagrees with the CPU")
    nbytes = window_step_bytes(CC_WINDOW, CC_ID_BOUND)
    nbytes["segment.count"] *= 2  # the src and the dst counts
    cell["profile"] = profile_cell(torch, "degrees", one_pass, DEG_STEPS, nbytes)
    return cell


def oracle_triangles(src, dst, n):
    """The triangle count of one window by scipy: the degree-oriented,
    deduplicated adjacency A (a -> b when (deg, id) of a is smaller), and
    the sum of (A @ A) * A."""
    from scipy.sparse import csr_matrix

    u = np.minimum(src, dst).astype(np.int64)
    v = np.maximum(src, dst).astype(np.int64)
    ok = u != v
    key = np.unique(u[ok] * n + v[ok])
    u, v = key // n, key % n
    deg = np.bincount(u, minlength=n) + np.bincount(v, minlength=n)
    swap = (deg[v] < deg[u]) | ((deg[v] == deg[u]) & (v < u))
    a = np.where(swap, v, u)
    b = np.where(swap, u, v)
    adj = csr_matrix((np.ones(len(a), np.int64), (a, b)), shape=(n, n))
    return int((adj @ adj).multiply(adj).sum())


def _tri_stream(src, dst, device="cuda", val=None):
    from gelly_streaming_tpu_torch import CountWindow, SimpleEdgeStream
    from gelly_streaming_tpu_torch.datasets import IdentityDict

    cols = (src, dst) if val is None else (src, dst, val)
    return SimpleEdgeStream(cols, window=CountWindow(TRI_WINDOW),
                            vertex_dict=IdentityDict(TRI_VERTICES), device=device)


def _tri_counts(src, dst):
    from gelly_streaming_tpu_torch import CountWindow
    from gelly_streaming_tpu_torch.library import WindowTriangles

    return WindowTriangles(CountWindow(TRI_WINDOW)).run_stream(_tri_stream(src, dst))


def phase_triangles(torch):
    from gelly_streaming_tpu_torch import CountWindow
    from gelly_streaming_tpu_torch.library.triangles import _oriented_degree_bucket
    from gelly_streaming_tpu_torch.ops.triangles import window_triangle_count

    src, dst = make_stream(TRI_VERTICES, TRI_WINDOW * TRI_WINDOWS, seed=TRI_SEED)
    kept = []

    def one_pass():
        kept[:] = [c for c, _ in _tri_counts(src, dst)]
        return len(kept)

    cell = timed_passes(torch, one_pass, TRI_WINDOW * TRI_WINDOWS)
    n, in_loop, after = count_syncs(torch, _tri_counts(src, dst))
    cell.update(host_syncs_in_loop=in_loop, host_syncs_per_window=in_loop / n,
                host_syncs_after_loop=after)
    got = [int(c) for c in kept]
    want = [oracle_triangles(src[a:a + TRI_WINDOW], dst[a:a + TRI_WINDOW], TRI_VERTICES)
            for a in range(0, len(src), TRI_WINDOW)]
    cell["counts"] = got
    say("triangles cell " + json.dumps(cell))
    say(f"triangles vs scipy: port {got}, scipy {want}: {'exact' if got == want else 'FAIL'}")
    if got != want or in_loop != 0 or cell["windows"] != TRI_WINDOWS:
        raise AssertionError("window triangles disagree with scipy or read the device per window")

    # window 0's per-vertex counts: the card against the CPU
    per = {}
    for device in ("cuda", "cpu"):
        block = next(_tri_stream(src, dst, device).slice(CountWindow(TRI_WINDOW))._block_iter_fn())
        s_h, d_h, _ = block.to_host()
        width = _oriented_degree_bucket(s_h, d_h, block.n_vertices)
        total, pv = window_triangle_count(block.src, block.dst, block.mask, block.n_vertices,
                                          width)
        per[device] = (int(total), pv.cpu().numpy(), width)
    ok = per["cuda"][0] == per["cpu"][0] == want[0] and np.array_equal(per["cuda"][1],
                                                                      per["cpu"][1])
    say(f"triangles window 0 per vertex: width {per['cuda'][2]}, {int((per['cuda'][1] > 0).sum())} "
        f"vertices in a triangle, sum {int(per['cuda'][1].sum())} (= 3 x {per['cuda'][0]}): "
        f"{'equal to the CPU' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("per-vertex triangle counts on the card disagree with the CPU")
    cell["width"] = per["cuda"][2]
    cell["profile"] = profile_cell(
        torch, "triangles", one_pass, TRI_STEPS,
        window_step_bytes(TRI_WINDOW, TRI_VERTICES, per["cuda"][2]))
    return cell


def _neighborhood_ops(torch):
    """The five neighborhood operations of phase 8, as (name, callable on
    a SnapshotStream, exact) with the UDFs written in torch."""
    def fold(acc, vid, nid, val):
        return acc[0] + 1, (acc[1] * 31 + nid) % 1000003, acc[2] * 0.5 + val

    def apply(vid, nbrs, vals, valid):
        return valid.sum(), torch.where(valid, vals, 0.0).amax()

    def flat(vid, nbrs, vals, valid):
        emit = valid & (nbrs > vid) & (vals > 0.99)
        return (torch.broadcast_to(vid, nbrs.shape), nbrs), emit

    return [
        ("reduce_on_edges(sum)", lambda s: s.reduce_on_edges("sum")),
        ("reduce_on_edges(callable)", lambda s: s.reduce_on_edges(lambda a, b: torch.add(a, b))),
        ("fold_neighbors", lambda s: s.fold_neighbors((0, 0, 0.0), fold)),
        ("apply_on_neighbors", lambda s: s.apply_on_neighbors(apply)),
        ("flat_apply_on_neighbors", lambda s: s.flat_apply_on_neighbors(flat, lambda d: d)),
    ]


def _split_numbers(records):
    """The integers and the floats of a list of (nested tuple) records."""
    ints, floats = [], []

    def walk(x):
        if isinstance(x, tuple):
            for y in x:
                walk(y)
        else:
            (floats if isinstance(x, float) else ints).append(x)

    for rec in records:
        walk(rec)
    return ints, np.asarray(floats, np.float64)


def phase_neighborhood(torch):
    from gelly_streaming_tpu_torch import EdgeDirection
    from gelly_streaming_tpu_torch.ops import segment

    src, dst = make_stream(TRI_VERTICES, TRI_WINDOW * TRI_WINDOWS, seed=TRI_SEED)
    src, dst = src[:TRI_WINDOW], dst[:TRI_WINDOW]
    val = np.random.default_rng(NBR_SEED).random(TRI_WINDOW).astype(np.float32)
    rows = {}
    for name, op in _neighborhood_ops(torch):
        res = {}
        for device in ("cuda", "cpu"):
            snap = _tri_stream(src, dst, device, val).slice(direction=EdgeDirection.ALL)
            turns = segment.FOLD_TURNS
            t0 = time.perf_counter()
            out = list(op(snap))
            if device == "cuda":
                torch.cuda.synchronize()
            res[device] = (out, (time.perf_counter() - t0) * 1e3, segment.FOLD_TURNS - turns)
        (g, g_ms, g_turns), (c, c_ms, c_turns) = res["cuda"], res["cpu"]
        gi, gf = _split_numbers(g)
        ci, cf = _split_numbers(c)
        err = float(np.max(np.abs(gf - cf) / np.maximum(np.abs(cf), 1.0))) if len(cf) else 0.0
        ok = len(g) == len(c) and gi == ci and gf.shape == cf.shape and err <= NBR_TOL
        rows[name] = {"records": len(g), "ms": g_ms, "cpu_ms": c_ms, "turns": g_turns,
                      "max_rel_err": err}
        say(f"neighborhood {name}: {len(g)} records, card {g_ms:.1f} ms, cpu {c_ms:.1f} ms"
            + (f", lockstep turns {g_turns} (cpu {c_turns})" if g_turns else "")
            + f", float max rel err {err:.2e} (tol {NBR_TOL:g}): "
            + ("equal to the CPU" if ok else "FAIL"))
        if not ok or g_turns != c_turns:
            raise AssertionError(f"{name} on the card disagrees with the CPU")
    deg = np.bincount(src, minlength=TRI_VERTICES) + np.bincount(dst, minlength=TRI_VERTICES)
    if rows["fold_neighbors"]["turns"] != deg.max():
        raise AssertionError("the fold did not run one lockstep turn per edge of the longest "
                             "neighborhood")
    return rows



# --------------------------------------------------------------------- #
# The remaining workloads (phases 9-13)
# --------------------------------------------------------------------- #
def _pr_stream(src, dst, device="cuda"):
    from gelly_streaming_tpu_torch import CountWindow, SimpleEdgeStream
    from gelly_streaming_tpu_torch.datasets import IdentityDict

    return SimpleEdgeStream((src, dst), window=CountWindow(PR_WINDOW),
                            vertex_dict=IdentityDict(PR_VERTICES), device=device)


def _pr_pass(stream, superbatch=1):
    """One pass of config #4 as ``bench_pagerank`` runs it (``sync()``
    inside): the workload, its emissions, seconds, and the fixpoints' host
    reads (``pagerank_kernels.HOST_READS``, the one counter of them)."""
    from gelly_streaming_tpu_torch.library import pagerank
    from gelly_streaming_tpu_torch.ops import pagerank_kernels

    pr = pagerank.IncrementalPageRank(tol=PR_TOL, max_iter=PR_MAX_ITER, superbatch=superbatch)
    pagerank_kernels.HOST_READS = 0
    t0 = time.perf_counter()
    ems = list(pr.run(stream))
    pr.sync()
    return pr, ems, time.perf_counter() - t0, pagerank_kernels.HOST_READS


def pagerank_oracle(src, dst, window, n_vertices, tol=PR_TOL, max_iter=PR_MAX_ITER,
                    chunk=10, damping=0.85):
    """The reference's procedure in float64 with scipy: per window append
    the edges, warm start (new seen vertices at 1/n, renormalize), power
    iterations until the L1 change is at most ``tol`` or the cap (max_iter
    rounded up to a chunk), dangling mass spread uniformly over the seen
    vertices (ids below 1 + the largest id seen). Returns the final ranks
    and the iterations of each window."""
    from scipy.sparse import csr_matrix

    cap = -(-max_iter // chunk) * chunk
    r = np.zeros(n_vertices)
    iters = []
    n_seen = 0
    for a in range(0, len(src), window):
        s, t = src[: a + window], dst[: a + window]
        n_seen = max(n_seen, 1 + int(max(src[a:a + window].max(), dst[a:a + window].max())))
        active = np.arange(n_vertices) < n_seen
        r = np.where(active & (r == 0.0), 1.0 / n_seen, r)
        r = r / max(r.sum(), 1e-30)
        out = np.bincount(s, minlength=n_vertices).astype(np.float64)
        m = csr_matrix((1.0 / out[s], (t, s)), shape=(n_vertices, n_vertices))
        dangling = active & (out == 0)
        for it in range(1, cap + 1):
            new = (1 - damping) / n_seen + damping * (m @ r + r[dangling].sum() / n_seen)
            new[~active] = 0.0
            dl = np.abs(new - r).sum()
            r = new
            if dl <= tol:
                break
        iters.append(it)
    return r, iters


def pr_step_bytes(n, e, v):
    """Bytes the PageRank steps must move per window of ``n`` new edges
    over ``e`` accumulated edges and ``v`` rank slots: each input read
    once, each output written once (the iterations re-read the edges; a
    bound counts them once). A second figure, ``pr_iteration_bytes``,
    counts ``iterations * (8 e + 12 v)``: each iteration must re-read the
    edge columns, read the ranks and write the new ones (and read its
    accumulator), at 3.35 TB/s."""
    return {
        # the block in and its copy into the carry; the fixpoint's
        "pagerank.window": 16 * n + 8 * e + 8 * v,
        # the edge columns and the ranks in, the ranks out
        "pagerank.fixpoint": 8 * e + 8 * v,
    }


def pr_iteration_bytes(iterations, e, v):
    """The fixpoint's bytes when every one of ``iterations`` iterations
    re-reads the ``e`` edges' two int32 columns and moves 12 bytes a rank
    slot (see ``pr_step_bytes``)."""
    return iterations * (8 * e + 12 * v)


def pr_fixpoint_bound(e, v, iterations):
    """(bound ms, bound_by) of one fixpoint: ``pr_step_bytes``' bytes over
    the card's memory rate against its float32 operations (an add an edge,
    about 8 a rank slot, each iteration) at the CUDA-core rate."""
    t_bytes = pr_step_bytes(0, e, v)["pagerank.fixpoint"] / HBM_BYTES_PER_S
    t_ops = iterations * (e + 8 * v) / PEAK_OPS_PER_S["float32"]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def pr_ranks_agree(r, p):
    """The kernel's ranks ``r`` against the plain version's ``p`` (float
    tensors of one shape): ``(max abs difference, the largest difference
    as a share of PR_KERNEL_RTOL * |p| + PR_KERNEL_FLOOR, the sum of r,
    whether all three are within their bounds)``."""
    diff = (r.double() - p.double()).abs()
    err = float(diff.max())
    rel = float((diff / (PR_KERNEL_RTOL * p.double().abs() + PR_KERNEL_FLOOR)).max())
    total = float(r.double().sum())
    return err, rel, total, err <= PR_KERNEL_TOL and rel <= 1.0 and abs(total - 1) <= 1e-5


def pr_in_degrees(torch, dst, nv):
    """The in-degree figures of one window's edges that set the pull
    kernel's split (``PR_ROW_THREAD``, ``PR_PIECE``)."""
    deg = torch.bincount(dst.long(), minlength=nv)
    nonempty = deg[deg > 0]
    out = {"max": int(deg.max()) if deg.numel() else 0,
           "mean_nonempty": float(nonempty.double().mean()) if nonempty.numel() else 0.0}
    for k in (PR_ROW_THREAD, 256, PR_PIECE):
        out[f"rows_over_{k}"] = int((deg > k).sum())
        out[f"entries_over_{k}"] = int(deg[deg > k].sum())
    out["pieces"] = int(((deg[deg > PR_ROW_THREAD] + PR_PIECE - 1) // PR_PIECE).sum())
    return out


def pagerank_kernel_row(torch, args, smi, where):
    """The fixpoint kernel on one window's operands (``args``, as the window
    step passed them to ``fixpoint``; ``where`` names the window) against
    ``fixpoint_plain`` on the same card tensors; then cold times in turns
    (kernel, plain, mv, mv, plain, kernel), the kernel with no iteration and
    with one (its set-up and its first iteration), the plain version's, and
    one iteration of ``torch.mv`` on a sparse CSR matrix of the carry (times
    the kernel's iterations; no single PyTorch call computes the fixpoint),
    beside both bounds."""
    from gelly_streaming_tpu_torch.ops import pagerank_kernels as pk

    src, dst, ranks, n_seen, damping, tol, chunk, max_chunks = args
    e, nv = src.shape[0], ranks.shape[0]

    def run(m=chunk * max_chunks):
        return pk._fixpoint_kernel(src, dst, ranks, n_seen, damping, tol, m)

    pr, pdelta, pit = pk.fixpoint_plain(*args)
    pit = int(pit)
    r, delta, it = run()
    err, rel, total, close = pr_ranks_agree(r, pr)
    it = int(it)
    say(f"pagerank kernel vs fixpoint_plain, {where} (E = {e}, V = {nv}): max abs rank "
        f"difference {err:.3e} (tol {PR_KERNEL_TOL:g}), largest difference {rel:.3e} of "
        f"{PR_KERNEL_RTOL:g} x |rank| + {PR_KERNEL_FLOOR:g} (tol 1), rank sum {total:.9f} "
        f"(tol 1e-05), iterations {it} and {pit} (tol +-{PR_ITER_SLACK}), l1 "
        f"{float(delta):.3e} and {float(pdelta):.3e}")
    if not (close and abs(it - pit) <= PR_ITER_SLACK):
        raise AssertionError(f"the PageRank kernel disagrees with fixpoint_plain at {where}")
    row = {"max_abs_err": err, "rel_err_share": rel, "iterations": it}
    del r
    deg = torch.zeros(nv, device=src.device).index_add_(
        0, src.long(), torch.ones(e, device=src.device))
    csr = torch.sparse_coo_tensor(torch.stack([dst.long(), src.long()]),
                                  1.0 / deg.clamp(min=1.0)[src.long()],
                                  (nv, nv)).coalesce().to_sparse_csr()
    del deg
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=src.device)
    lead = KR_LEAD_CYCLES
    plain = lambda: pk.fixpoint_plain(*args)  # noqa: E731
    mv = lambda: torch.mv(csr, pr)  # noqa: E731

    def cold(fn):
        return cold_ms(torch, fn, flush, lead_cycles=lead)

    turns = {"ms": [cold(run)]}
    turns["plain_ms"] = [cold_ms(torch, plain, flush, iters=5, warmup=1, lead_cycles=lead)]
    turns["mv_ms"] = [cold(mv)]
    row["setup_ms"] = cold(lambda: run(0))
    row["one_iteration_ms"] = cold(lambda: run(1))
    turns["mv_ms"].append(cold(mv))
    turns["plain_ms"].append(cold_ms(torch, plain, flush, iters=5, warmup=1, lead_cycles=lead))
    turns["ms"].append(cold(run))
    del flush, csr
    for name, pair in turns.items():
        row[name] = sum(pair) / 2
        row[name + "_turns"] = pair
    row["first_iteration_ms"] = row["one_iteration_ms"] - row["setup_ms"]
    row["ms_an_iteration"] = (row["ms"] - row["setup_ms"]) / max(it, 1)
    row["bound_ms"], row["bound_by"] = pr_fixpoint_bound(e, nv, it)
    row["iteration_bound_ms"] = pr_iteration_bytes(it, e, nv) / HBM_BYTES_PER_S * 1e3
    row["bound_share"] = row["bound_ms"] / row["ms"]
    row["iteration_bound_share"] = row["iteration_bound_ms"] / row["ms"]
    # the edges can stay in L2 between iterations, so only the byte rule's
    # bound is one a kernel cannot beat
    if row["bound_share"] > 1.0:
        raise AssertionError("the fixpoint ran faster than its bound: the timing is wrong")
    row["library_ms"] = row["mv_ms"] * it
    row["in_degrees"] = pr_in_degrees(torch, dst, nv)
    row["per"] = (f"one fixpoint of {where}: E = {e}, V = {nv}, {it} iterations, cold L2; "
                  f"{smi}")
    say(f"pagerank fixpoint times, {where} (cold L2, median of each call alone) "
        + json.dumps(row))
    return row


def phase_pagerank(torch, smi=None):
    """BASELINE config #4 (``bench.py:bench_pagerank``) through the fixpoint
    kernel, a scale pass on phase 5's corpus, and the kernel's row."""
    from gelly_streaming_tpu_torch import CountWindow, datasets
    from gelly_streaming_tpu_torch.ops import pagerank_kernels as pk

    src, dst = make_stream(PR_VERTICES, PR_EDGES, seed=PR_SEED)
    n_win = PR_EDGES // PR_WINDOW
    # the warm pass; the last window's fixpoint operands kept (a window's
    # edge prefix and rank vector are never written after its step)
    kept, real = [], pk.fixpoint

    def keep(*args):
        kept[:] = args
        return real(*args)

    pk.fixpoint = keep
    try:
        _pr_pass(_pr_stream(src, dst))
    finally:
        pk.fixpoint = real
    # the main path, counted
    pk.LAUNCHES = 0
    runs = [_pr_pass(_pr_stream(src, dst)) for _ in range(STEADY_PASSES)]
    launches = pk.LAUNCHES
    times = [r[2] for r in runs]
    mid = sorted(range(len(runs)), key=lambda i: times[i])[len(runs) // 2]
    pr, ems, sec, reads = runs[mid]
    iters = [int(e.iterations) for e in ems]
    cell = {"windows": len(ems), "edges_per_s": PR_EDGES / sec, "ms_per_window": sec / n_win * 1e3,
            "edges_per_s_all": [PR_EDGES / t for t in times], "pass_s": times,
            "iterations_per_window": iters, "host_reads_per_window": reads / len(ems),
            "host_reads_all": [r[3] for r in runs],
            "kernel_launches_per_window": launches / (STEADY_PASSES * n_win),
            "l1_delta": [float(e.l1_delta) for e in ems]}
    say("pagerank cell " + json.dumps(cell))
    if len(ems) != n_win:
        raise AssertionError(f"pagerank ran {len(ems)} windows")
    if launches != STEADY_PASSES * n_win or any(r[3] for r in runs):
        raise AssertionError(f"pagerank launched its fixpoint kernel {launches} times in "
                             f"{STEADY_PASSES * n_win} windows, host reads "
                             f"{[r[3] for r in runs]}: expected one launch and no read a window")

    t0 = time.perf_counter()
    want, want_iters = pagerank_oracle(src, dst, PR_WINDOW, PR_VERTICES)
    got = pr._carry[2].cpu().numpy().astype(np.float64)
    err = float(np.abs(got - want).max())
    it_diff = max(abs(a - b) for a, b in zip(iters, want_iters))
    ok = err <= PR_RANK_TOL and it_diff <= PR_ITER_SLACK and abs(got.sum() - 1) <= 1e-5
    say(f"pagerank vs the float64 scipy oracle ({time.perf_counter() - t0:.1f} s): max abs rank "
        f"error {err:.3e} (tol {PR_RANK_TOL:g}), iterations port {iters} oracle {want_iters} "
        f"(tol +-{PR_ITER_SLACK}), rank sum {got.sum():.7f}: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("config #4 PageRank disagrees with the float64 oracle")
    cell.update(max_abs_rank_err=err, oracle_iterations=want_iters)

    pr4, ems4, sec4, reads4 = _pr_pass(_pr_stream(src, dst), superbatch=4)
    err4 = float((pr4._carry[2] - pr._carry[2]).abs().max())
    say(f"pagerank superbatch 4: {sec4 * 1e3 / len(ems4):.2f} ms a window, iterations "
        f"{[int(e.iterations) for e in ems4]}, max abs rank difference to superbatch 1 "
        f"{err4:.3e} (tol {PR_K4_TOL:g}): {'ok' if err4 <= PR_K4_TOL else 'FAIL'}")
    if not err4 <= PR_K4_TOL or len(ems4) != n_win or reads4:
        raise AssertionError("PageRank with superbatch 4 disagrees with superbatch 1 (or read "
                             "the device)")
    cell["superbatch4_max_abs_diff"] = err4

    # the scale pass: the first PR_SCALE_WINDOWS windows of the livejournal
    # surrogate's binary cache, as a binary file of their own
    spec = datasets.CORPORA[CC_CORPUS]
    n_edges = PR_SCALE_WINDOWS * CC_WINDOW
    prefix_path = os.path.join(_cache_dir(), "smoke_pagerank_prefix.gbin")
    datasets.write_binary(prefix_path, *_corpus_prefix(n_edges))
    stream = datasets.stream_file(prefix_path, window=CountWindow(CC_WINDOW),
                                  vertex_dict=datasets.IdentityDict(CC_ID_BOUND),
                                  prefetch_depth=2, device="cuda")
    kept_s = []

    def keep_s(*args):
        kept_s[:] = args
        return real(*args)

    pk.fixpoint = keep_s
    pk.LAUNCHES = 0
    try:
        prs, ems_s, sec_s, reads_s = _pr_pass(stream)
    finally:
        pk.fixpoint = real
    launches_s = pk.LAUNCHES
    os.remove(prefix_path)
    rs, rd = rmat_oracle_edges(spec.surrogate_edges,
                               int(spec.surrogate_vscale).bit_length() - 1)
    t1 = time.perf_counter()
    want_s, want_iters_s = pagerank_oracle(rs[:n_edges], rd[:n_edges], CC_WINDOW, CC_ID_BOUND)
    got_s = prs._carry[2].cpu().numpy().astype(np.float64)
    err_s = float(np.abs(got_s - want_s).max())
    iters_s = [int(e.iterations) for e in ems_s]
    scale = {"windows": len(ems_s), "edges_per_s": n_edges / sec_s,
             "ms_per_window": sec_s / len(ems_s) * 1e3, "iterations_per_window": iters_s,
             "oracle_iterations": want_iters_s, "host_reads_per_window": reads_s / len(ems_s),
             "kernel_launches": launches_s, "max_abs_rank_err": err_s}
    say(f"pagerank scale pass ({CC_CORPUS} surrogate, its first {n_edges} edges, oracle "
        f"{time.perf_counter() - t1:.1f} s) " + json.dumps(scale))
    if (len(ems_s) != PR_SCALE_WINDOWS or not err_s <= PR_RANK_TOL or reads_s
            or launches_s != PR_SCALE_WINDOWS):
        raise AssertionError("the PageRank scale pass disagrees with the float64 oracle (or "
                             "read the device, or did not launch the kernel once a window)")
    cell["scale"] = scale
    cell["kernel_row"] = pagerank_kernel_row(torch, kept, smi, "config #4's last window")
    cell["kernel_row"]["launches"] = launches
    cell["kernel_row_scale"] = pagerank_kernel_row(
        torch, kept_s, smi, f"the scale pass's last window ({CC_CORPUS} surrogate)")
    del kept_s
    cell["profile"] = profile_cell(
        torch, "pagerank", lambda: len(_pr_pass(_pr_stream(src, dst))[1]), PR_STEPS,
        pr_step_bytes(PR_WINDOW, PR_EDGES * (n_win + 1) // (2 * n_win), PR_VERTICES),
        foreign=PR_FOREIGN)
    return cell


def _bip_stream(path_or_cols, device="cuda"):
    from gelly_streaming_tpu_torch import CountWindow, SimpleEdgeStream, datasets

    if isinstance(path_or_cols, str):
        return datasets.stream_file(path_or_cols, window=CountWindow(CC_WINDOW),
                                    vertex_dict=datasets.IdentityDict(CC_ID_BOUND),
                                    prefetch_depth=2, device=device)
    return SimpleEdgeStream(path_or_cols, window=CountWindow(CC_WINDOW),
                            vertex_dict=datasets.IdentityDict(CC_ID_BOUND), device=device)


def _bip_pass(source, carry="auto", superbatch=1, windows=None):
    """One pass of ``bench_bipartiteness_e2e``: the emissions (all, or the
    first ``windows``), seconds, the carry, host reads."""
    from gelly_streaming_tpu_torch.library import BipartitenessCheck
    from gelly_streaming_tpu_torch.summaries import labels

    agg = BipartitenessCheck(carry=carry, superbatch=superbatch)
    labels.HOST_READS = 0
    t0 = time.perf_counter()
    kept = []
    it = _bip_stream(source).aggregate(agg)
    for c in it:
        kept.append(c)
        if windows and len(kept) == windows:
            it.close()
            break
    agg.sync()
    return kept, time.perf_counter() - t0, agg._bp_mode, labels.HOST_READS


def bipartite_oracle(src, dst, n):
    """Bipartite iff no seen vertex's two cover nodes share a component of
    the 2n-node signed double cover (scipy's connected components)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    u = np.concatenate([src, src + n])
    w = np.concatenate([dst + n, dst])
    g = coo_matrix((np.ones(len(u), np.int8), (u, w)), shape=(2 * n, 2 * n))
    _, comp = connected_components(g, directed=True, connection="weak")
    seen = np.zeros(n, bool)
    seen[src] = True
    seen[dst] = True
    v = np.nonzero(seen)[0]
    return not bool(np.any(comp[v] == comp[v + n]))


def _coloring_ok(cand, src, dst):
    """Whether a bipartite emission's components are a proper 2-coloring of
    the edges: both ends in one component, on opposite sides."""
    col = cand.coloring()
    if col is None:
        return False
    ids, comp, sign = col
    c = np.full(CC_ID_BOUND, -1, np.int64)
    g = np.zeros(CC_ID_BOUND, bool)
    c[ids] = comp
    g[ids] = sign
    return bool(np.all(c[src] >= 0) and np.all(c[src] == c[dst]) and np.all(g[src] != g[dst]))


def cover_step_bytes(t, n, v):
    """Bytes of the signed-cover window step for ``n`` edges touching ``t``
    vertices over ``v`` base vertices: the CC forest step's
    (``cc_step_bytes``) over both cover halves, the 2v-entry forest copied
    once."""
    return {"bip.cover_step": 2 * 21 * t + 2 * (8 * n + 16 * t) + 16 * v + 2 * 17 * t}


def phase_bipartiteness(torch):
    """``bench.py:bench_bipartiteness_e2e`` on phase 6's binary cache."""
    from gelly_streaming_tpu_torch import datasets

    path, _ = datasets.ensure_corpus(CC_CORPUS)
    spec = datasets.CORPORA[CC_CORPUS]
    n_edges = spec.surrogate_edges
    bin_path = datasets.binary_cache(path)
    _bip_pass(bin_path)  # warm
    runs = [_bip_pass(bin_path) for _ in range(STEADY_PASSES)]
    times = [r[1] for r in runs]
    mid = sorted(range(len(runs)), key=lambda i: times[i])[len(runs) // 2]
    ems, sec, mode, reads = runs[mid]
    cell = {"windows": len(ems), "edges_per_s": n_edges / sec,
            "ms_per_window": sec / len(ems) * 1e3,
            "edges_per_s_all": [n_edges / t for t in times], "pass_s": times, "carry": mode,
            "host_reads_per_window": reads / len(ems)}
    say("bipartiteness cell " + json.dumps(cell))
    if mode != "forest" or len(ems) != n_edges // CC_WINDOW:
        raise AssertionError(f"bipartiteness ran carry {mode} over {len(ems)} windows")

    src, dst = rmat_oracle_edges(n_edges, int(spec.surrogate_vscale).bit_length() - 1)
    t0 = time.perf_counter()
    want = [bipartite_oracle(src[:CC_WINDOW], dst[:CC_WINDOW], CC_ID_BOUND),
            bipartite_oracle(src, dst, CC_ID_BOUND)]
    got = [ems[0].success, ems[-1].success]
    say(f"bipartiteness vs scipy on the double cover ({time.perf_counter() - t0:.1f} s): window 0 "
        f"and last: port {got}, scipy {want}: {'equal' if got == want else 'FAIL'}")
    if got != want:
        raise AssertionError("the bipartiteness verdict disagrees with scipy")
    del ems, runs

    # the same edges mapped to (u & ~1, v | 1): bipartite by construction
    bsrc = (src & ~1).astype(np.int32)
    bdst = (dst | 1).astype(np.int32)
    ems_b, sec_b, mode_b, reads_b = _bip_pass((bsrc, bdst))
    col_ok = _coloring_ok(ems_b[0], bsrc[:CC_WINDOW], bdst[:CC_WINDOW])
    verdict = ems_b[-1].success
    say(f"bipartiteness on (u & ~1, v | 1) ({sec_b * 1e3 / len(ems_b):.1f} ms a window, carry "
        f"{mode_b}, {reads_b / len(ems_b):.1f} host reads a window): last verdict {verdict}, "
        f"window 0 a proper 2-coloring: {col_ok}")
    if not (verdict and col_ok):
        raise AssertionError("the bipartite-by-construction stream was not found bipartite")
    cell["mapped"] = {"ms_per_window": sec_b * 1e3 / len(ems_b), "bipartite": verdict,
                      "host_reads_per_window": reads_b / len(ems_b)}
    del ems_b

    # the other carries and the superbatch on the first windows, both streams
    for source, label in ((bin_path, "rmat"), ((bsrc, bdst), "mapped")):
        base = _bip_pass(source, carry="forest", windows=CC_PREFIX_WINDOWS)[0]
        base_v = [c.success for c in base]
        base_c = [c.coloring() for c in base]
        for carry, k in (("host", 1), ("dense", 1), ("forest", CC_PREFIX_WINDOWS)):
            ems_k, sec_k, mode_k, _ = _bip_pass(source, carry=carry, superbatch=k,
                                                windows=CC_PREFIX_WINDOWS)
            same = [c.success for c in ems_k] == base_v and mode_k == carry
            if same and label == "mapped":
                same = all(np.array_equal(a[0], b[0]) and np.array_equal(a[2], b[2])
                           for a, b in zip(base_c, (c.coloring() for c in ems_k)))
            say(f"bipartiteness prefix {CC_PREFIX_WINDOWS} windows ({label}), carry {mode_k} "
                f"superbatch {k}: {sec_k * 1e3 / len(ems_k):.1f} ms a window, "
                f"{'equal to the forest carry' if same else 'FAIL'}")
            if not same:
                raise AssertionError(f"bipartiteness carry {carry} (superbatch {k}) disagrees")
    touched = np.unique(np.concatenate([src[:CC_WINDOW], dst[:CC_WINDOW]])).size
    cell["profile"] = profile_cell(
        torch, "bipartiteness", lambda: len(_bip_pass(bin_path, windows=CC_PREFIX_WINDOWS)[0]),
        BIP_STEPS, cover_step_bytes(touched, CC_WINDOW, CC_ID_BOUND))
    return cell


def _etc_batches(src, dst, device="cuda"):
    from gelly_streaming_tpu_torch import CountWindow, SimpleEdgeStream
    from gelly_streaming_tpu_torch.datasets import IdentityDict
    from gelly_streaming_tpu_torch.library import ExactTriangleCount

    stream = SimpleEdgeStream((src, dst), window=CountWindow(ETC_WINDOW),
                              vertex_dict=IdentityDict(ETC_VERTICES), device=device)
    etc = ExactTriangleCount()
    return etc, etc.run(stream)


def oracle_prefix_triangles(src, dst, n):
    """Total and per-vertex triangle counts of the deduplicated undirected
    simple graph of the edges, by scipy: ``(A @ A).multiply(A)``."""
    from scipy.sparse import csr_matrix

    u = np.minimum(src, dst).astype(np.int64)
    v = np.maximum(src, dst).astype(np.int64)
    ok = u != v
    key = np.unique(u[ok] * n + v[ok])
    u, v = key // n, key % n
    a = csr_matrix((np.ones(2 * len(u), np.int64), (np.concatenate([u, v]),
                                                    np.concatenate([v, u]))), shape=(n, n))
    per = np.asarray((a @ a).multiply(a).sum(axis=1)).ravel() // 2
    return int(per.sum() // 3), per


def etc_step_bytes(n, p, v):
    """Bytes of the exact counter's steps per window of ``n`` slots, ``p``
    packed entries, ``v`` vertices: each input read once, each output
    written once."""
    return {
        # src, dst, mask and the packed columns in; the packed columns,
        # row_ptr and the four query columns out
        "tri.packed_prep": 9 * n + 12 * p + 12 * p + 4 * v + 13 * n,
        # pn, pr, row_ptr, the query columns and the counts in; counts out
        "tri.packed_count": 8 * p + 4 * v + 13 * n + 8 * v,
    }


def phase_exact_triangles(torch):
    """``bench.py:bench_exact_triangles``: batches left unread until the
    pass ends, then every window's running total and per-vertex counts held
    exactly against scipy on the prefix graph."""
    src, dst = make_stream(ETC_VERTICES, ETC_EDGES, seed=ETC_SEED)
    kept = []

    def one_pass():
        etc, it = _etc_batches(src, dst)
        kept[:] = list(it)
        etc.sync()
        return len(kept)

    cell = timed_passes(torch, one_pass, ETC_EDGES)
    n, in_loop, after = count_syncs(torch, _etc_batches(src, dst)[1])
    cell.update(host_syncs_in_loop=in_loop, host_syncs_per_window=in_loop / n,
                host_syncs_after_loop=after)
    say("exact triangles cell " + json.dumps(cell))
    if in_loop != 0 or cell["windows"] != ETC_EDGES // ETC_WINDOW:
        raise AssertionError(f"the exact counter ran {cell['windows']} windows with {in_loop} "
                             "host syncs in the loop")
    t0 = time.perf_counter()
    counts = np.zeros(ETC_VERTICES, np.int64)
    total = 0
    ok = True
    totals = []
    for i, batch in enumerate(kept):
        for vid, c in batch:
            if vid == -1:
                total = c
            else:
                counts[vid] = c
        want_total, want_per = oracle_prefix_triangles(src[: (i + 1) * ETC_WINDOW],
                                                       dst[: (i + 1) * ETC_WINDOW], ETC_VERTICES)
        ok = ok and total == want_total and np.array_equal(counts, want_per)
        totals.append((total, want_total))
    say(f"exact triangles vs scipy, every window ({time.perf_counter() - t0:.1f} s): running "
        f"totals (port, scipy) {totals}, per-vertex counts {'exact' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the exact triangle counts disagree with scipy")
    cell["totals"] = [t for t, _ in totals]
    etc, it = _etc_batches(src, dst)
    list(it)
    cell["profile"] = profile_cell(torch, "exact triangles", one_pass, ETC_STEPS,
                                   etc_step_bytes(ETC_WINDOW, etc._n_packed, ETC_VERTICES))
    return cell


def _spanner_run(src, dst, k, window, n_vertices, device="cuda", expected=0):
    from gelly_streaming_tpu_torch import CountWindow, SimpleEdgeStream
    from gelly_streaming_tpu_torch.datasets import IdentityDict
    from gelly_streaming_tpu_torch.library import DeviceSpanner

    stream = SimpleEdgeStream((src, dst), window=CountWindow(window),
                              vertex_dict=IdentityDict(n_vertices), device=device)
    sp = DeviceSpanner(k=k, expected_edges=expected)
    return sp, sp.run(stream)


def _spanner_edges(sp):
    su, sv = sp._host_columns()
    key = (su.astype(np.int64) << 32) | sv.astype(np.int64)
    return np.sort(key)


def spanner_check_2hops(src, dst, keys, n):
    """Every distinct stream edge not in the spanner has a spanner path of
    at most 2 hops (the spanner rows of its ends share a vertex), by sparse
    products over chunks of the dropped edges. Returns (dropped, bad)."""
    from scipy.sparse import csr_matrix

    u = np.minimum(src, dst).astype(np.int64)
    v = np.maximum(src, dst).astype(np.int64)
    ok = u != v
    cand = np.unique((u[ok] << 32) | v[ok])
    dropped = cand[~np.isin(cand, keys)]
    su, sv = keys >> 32, keys & 0xFFFFFFFF
    s = csr_matrix((np.ones(2 * len(su), np.int8), (np.concatenate([su, sv]),
                                                    np.concatenate([sv, su]))), shape=(n, n))
    du, dv = dropped >> 32, dropped & 0xFFFFFFFF
    bad = 0
    for a in range(0, len(dropped), 1 << 14):
        rows = s[du[a:a + (1 << 14)]].multiply(s[dv[a:a + (1 << 14)]])
        bad += int(np.sum(np.asarray(rows.sum(axis=1)).ravel() == 0))
    return len(dropped), bad


def spanner_step_bytes(q, p, v):
    """Bytes of the k = 2 spanner steps per window of ``q`` first-seen
    queries over ``p`` packed entries and ``v`` vertices."""
    return {
        # pn, row_ptr, the queries and their class selection in; the
        # accumulator out (per window, all classes)
        "spanner.k2": 4 * p + 4 * v + 12 * q + q,
        # the packed columns and the queries in, the packed columns out
        "spanner.k2_merge": 12 * p + 10 * q + 12 * p,
    }


def phase_spanner(torch, smi):
    """``bench.py:bench_spanner``: k = 2 with ``expected_edges``, the edge
    set against the port on the CPU and the 2-hop guarantee; then k = 3 on
    a prefix and on a small stream, against the CPU; then the reference's
    k = 3 cell at its own size through the search kernel
    (``phase_spanner_k3``, with the kernel's checks against its plain
    version)."""
    src, dst = make_stream(SP_VERTICES, SP_EDGES, seed=SP_SEED)

    def one_pass():
        sp, it = _spanner_run(src, dst, 2, SP_WINDOW, SP_VERTICES, expected=SP_EDGES)
        n = sum(1 for _ in it)
        sp.sync()
        return n

    cell = timed_passes(torch, one_pass, SP_EDGES)
    n, in_loop, after = count_syncs(
        torch, _spanner_run(src, dst, 2, SP_WINDOW, SP_VERTICES, expected=SP_EDGES)[1])
    cell.update(host_syncs_in_loop=in_loop, host_syncs_per_window=in_loop / n,
                host_syncs_after_loop=after)
    say("spanner cell " + json.dumps(cell))
    if in_loop != 0 or cell["windows"] != SP_EDGES // SP_WINDOW:
        raise AssertionError("the device spanner read the device in its window loop")
    sp, it = _spanner_run(src, dst, 2, SP_WINDOW, SP_VERTICES, expected=SP_EDGES)
    list(it)
    got = _spanner_edges(sp)
    t0 = time.perf_counter()
    sp_c, it_c = _spanner_run(src, dst, 2, SP_WINDOW, SP_VERTICES, device="cpu",
                              expected=SP_EDGES)
    list(it_c)
    want = _spanner_edges(sp_c)
    cpu_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    dropped, bad = spanner_check_2hops(src, dst, got, SP_VERTICES)
    same = np.array_equal(got, want)
    say(f"spanner k=2: {len(got)} edges kept, {dropped} dropped, the port on the CPU "
        f"({cpu_s:.1f} s) {'equal' if same else 'FAIL'}, dropped edges without a 2-hop path "
        f"{bad} ({time.perf_counter() - t1:.1f} s)")
    if not same or bad:
        raise AssertionError("the device spanner disagrees with the CPU or breaks the 2-hop bound")
    cell.update(kept=int(len(got)), dropped=dropped)

    # k = 3: the 2^18-edge prefix (one window), then a smaller stream in
    # four windows, so the frontier search meets a spanner
    k3 = {}
    for label, (s3, d3, w3, v3) in {
        "prefix": (src[:SP_WINDOW], dst[:SP_WINDOW], SP_WINDOW, SP_VERTICES),
        "windows": (src[:SP3_EDGES] % SP3_VERTICES, dst[:SP3_EDGES] % SP3_VERTICES,
                    SP3_EDGES // 4, SP3_VERTICES),
    }.items():
        res = {}
        for device in ("cuda", "cpu"):
            t2 = time.perf_counter()
            sp3, it3 = _spanner_run(s3, d3, 3, w3, v3, device=device)
            nw = sum(1 for _ in it3)
            sp3.sync()
            res[device] = (_spanner_edges(sp3), time.perf_counter() - t2, nw)
        same3 = np.array_equal(res["cuda"][0], res["cpu"][0])
        k3[label] = {"edges": len(s3), "windows": res["cuda"][2], "kept": int(len(res["cuda"][0])),
                     "card_s": res["cuda"][1], "cpu_s": res["cpu"][1], "equal": same3}
        say(f"spanner k=3 {label}: " + json.dumps(k3[label]))
        if not same3:
            raise AssertionError("the k=3 device spanner on the card disagrees with the CPU")
    cell["k3"] = k3
    q = SP_WINDOW  # at most the window's first-seen queries
    cell["profile"] = profile_cell(torch, "spanner", one_pass, SP_STEPS,
                                   spanner_step_bytes(q, 2 * len(got), SP_VERTICES))
    s3, d3 = src[:SP3_EDGES] % SP3_VERTICES, dst[:SP3_EDGES] % SP3_VERTICES

    def k3_pass():
        sp3, it3 = _spanner_run(s3, d3, 3, SP3_EDGES // 4, SP3_VERTICES)
        n3 = sum(1 for _ in it3)
        sp3.sync()
        return n3

    cell["profile_k3"] = profile_cell(
        torch, "spanner k=3", k3_pass, SP3_STEPS,
        k_reach_bytes(k3["windows"]["kept"] // 2, SP3_EDGES // 4, SP3_VERTICES),
        foreign=SP3_FOREIGN)
    cell["k3_eps"] = phase_spanner_k3(torch, smi)
    return cell


def k_reach_bytes(s, q, v):
    """Bytes of the k >= 3 steps per window: each input read once, each
    output written once. The CSR build reads the window-start columns
    (``s`` edges) and writes ``row_ptr`` over ``v`` vertices and the sorted
    sources and targets; the search reads the columns and the ``q``
    queries and writes the verdicts; the append reads the columns and the
    queries and writes the new columns."""
    return {"spanner.csr": 8 * s + 4 * (v + 1) + 16 * s,
            "spanner.k_reach": 8 * s + 10 * q, "spanner.append": 8 * s + 9 * q + 8 * s}


def k_reach_frontier_bytes(k, s, v, w):
    """The frontier traffic one search needs, a second figure beside the
    bytes of ``k_reach_bytes``: each of k hops reads the ``2 s`` entries'
    source rows of ``w`` int32 words and reads and writes the ``v`` rows."""
    return k * (2 * s * w * 4 + 2 * v * w * 4)


def k_reach_call_bound(s, v, b, k):
    """(bound ms, bound_by) of one search of ``b`` queries: its inputs read
    once (``row_ptr`` over ``v`` vertices, the ``2 s`` sorted sources, the
    queries) and its verdicts written once over the card's memory rate,
    against its k * 2s * (b / 32) word ORs at the CUDA-core rate."""
    nbytes = 4 * (v + 1) + 8 * s + 9 * b + b
    ops = k * 2 * s * (b // 32)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S["float32"]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def k_reach_active_traffic(csr, u, m, nv, k):
    """The bytes one search of the search kernel's design must move on these
    inputs, from a numpy BFS of the batch (a third figure beside
    ``k_reach_call_bound`` and ``k_reach_frontier_bytes``): the seed's
    queries and words; per hop ``row_ptr``, the live sources, the two
    bitmaps read and the two written, the rows of the sources the hop before
    changed (gathered whole), the non-zero own rows read, and the non-zero
    words written; the read-out; the clearing of the rows non-zero after
    the last two hops. Returns the bytes and per hop the rows gathered,
    read and written."""
    rp = csr.row_ptr.cpu().numpy().astype(np.int64)
    live = int(rp[nv])
    src = csr.src[:live].cpu().numpy().astype(np.int64)
    dst = np.repeat(np.arange(nv), np.diff(rp))
    b = u.shape[0]
    w = b // 32
    un, mn = u.cpu().numpy(), m.cpu().numpy()
    front = np.zeros((nv, w), np.uint32)
    i = np.flatnonzero(mn)
    np.bitwise_or.at(front, (un[i], i // 32), (np.uint32(1) << (i % 32).astype(np.uint32)))
    changed = np.zeros(nv, bool)
    changed[un[mn]] = True
    nonzero = changed.copy()
    row, bmap = 4 * w, 4 * ((nv + 127) // 128) * 4
    nbytes = 9 * b + 4 * len(i)
    hops = []
    for _ in range(k):
        hot = changed[src]
        acc = np.where(nonzero[:, None], front, np.uint32(0))
        if hot.any():
            d = dst[hot]
            starts = np.flatnonzero(np.r_[True, d[1:] != d[:-1]])
            acc[d[starts]] |= np.bitwise_or.reduceat(front[src[hot]], starts, axis=0)
        hop = {"gathered": int(hot.sum()), "own_read": int(nonzero.sum()),
               "written_words": int(np.count_nonzero(acc))}
        nbytes += (4 * (nv + 1) + 4 * live + 4 * bmap + row * hop["gathered"]
                   + row * hop["own_read"] + 4 * hop["written_words"])
        prev_nonzero = nonzero
        changed = (acc != front).any(axis=1)
        nonzero = (acc != 0).any(axis=1)
        front = acc
        hops.append(hop)
    last_two = int(nonzero.sum()) + (int(prev_nonzero.sum()) if k else 0)
    nbytes += 9 * b + 4 * b + row * last_two + 4 * bmap
    return {"bytes": nbytes, "hops": hops, "cleared_rows": last_two}


def _kr_inputs(torch, device, seed, b, nv, s, cnt, k):
    """A seeded spanner of ``s`` columns among vertices ``0 .. V - 2`` (an
    eighth self-loops, an eighth repeated edges), ``cnt`` of them live, and
    ``b`` queries on ``device``: half end a random walk of up to k + 1 steps
    from ``u``, a twentieth are ``u == v``, a fifth are masked."""
    from gelly_streaming_tpu_torch.ops import reach_kernels as rk

    rng = np.random.default_rng(seed)
    hi = max(nv - 1, 1)
    sp = rng.integers(0, hi, s)
    sq = rng.integers(0, hi, s)
    e = s // 8
    sq[:e] = sp[:e]
    sp[e:2 * e], sq[e:2 * e] = sp[2 * e:3 * e], sq[2 * e:3 * e]
    a, c = np.concatenate([sp, sq]), np.concatenate([sq, sp])
    order = np.argsort(a, kind="stable")
    a, c = a[order], c[order]
    ptr = np.searchsorted(a, np.arange(nv + 1))
    u = rng.integers(0, nv, b)
    x = u.copy()
    steps = rng.integers(1, k + 2, b)
    for step in range(k + 1):
        deg = ptr[x + 1] - ptr[x]
        pick = np.minimum(ptr[x] + (rng.random(b) * np.maximum(deg, 1)).astype(np.int64),
                          len(c) - 1)
        x = np.where((step < steps) & (deg > 0), c[pick], x)
    v = np.where(rng.random(b) < 0.5, x, rng.integers(0, nv, b))
    v = np.where(rng.random(b) < 0.05, u, v)
    m = rng.random(b) >= 0.2
    t = [torch.from_numpy(np.ascontiguousarray(y)).to(device)
         for y in (sp.astype(np.int32), sq.astype(np.int32), u.astype(np.int32),
                   v.astype(np.int32), m)]
    csr = rk.target_csr(t[0], t[1], torch.tensor(cnt, dtype=torch.int32, device=device), nv)
    return csr, t[2], t[3], t[4]


def _k_reach_equal(torch, rk, label, csr, u, v, m, nv, k):
    """One wrapper call on the card, which must launch the search kernel
    once, against the plain version: the answers must be equal. Returns the
    count of reached queries."""
    before = rk.LAUNCHES
    got = rk.k_reach(csr, u, v, m, nv, k)
    torch.cuda.synchronize()
    launched = rk.LAUNCHES - before
    want = rk.k_reach_plain(csr, u, v, m, nv, k)
    if not (bool(torch.equal(got, want)) and launched == 1):
        diff = int((got != want).sum())
        raise AssertionError(f"k_reach kernel != plain at {label}: {diff} answers differ, "
                             f"{launched} launches for k = {k}")
    return int(got.sum())


def phase_k_reach_checks(torch, captured):
    """(a) The search kernel against the plain version on the card,
    exactly: seeded spanners over ragged vertex counts, W = 1, 3 and 32
    words, no, some and all columns live, k = 1 to 4; then the captured
    first batch of windows 1-3 of the k = 3 cell."""
    from gelly_streaming_tpu_torch.ops import reach_kernels as rk

    device = captured[0]["args"][1].device  # the main path's card
    cases = reached = 0
    for nv in KR_VERTICES:
        s = KR_EDGES * nv
        for b in KR_BATCHES:
            for cnt in (0, s // 2 + 1, s):
                for k in (1, 2, 3, 4):
                    args = _kr_inputs(torch, device, cases, b, nv, s, cnt, k)
                    reached += _k_reach_equal(torch, rk, f"V={nv} B={b} cnt={cnt} k={k}",
                                              *args, nv, k)
                    cases += 1
    say(f"k_reach kernel vs plain: {cases} seeded cases equal ({reached} queries reached)")
    for w, rec in enumerate(captured, start=1):
        csr, u, v, m, nv, k = rec["args"]
        n = _k_reach_equal(torch, rk, f"window {w}'s first batch", csr, u, v, m, nv, k)
        say(f"k_reach kernel vs plain, window {w}'s first batch (B = {u.shape[0]}, S = "
            f"{rec['s']}, V = {nv}, k = {k}): equal, {n} reached")
    return cases


def spanner_check_3hops(src, dst, keys, n, sample, seed):
    """A seeded sample of ``sample`` of the distinct stream edges not in the
    spanner: each must have a spanner path of at most 3 hops, through a
    common neighbour (``S[u] . S[v] > 0``) or a walk of 3
    (``(S[u] @ S) . S[v] > 0``), by sparse products. Returns (dropped,
    sampled, bad)."""
    from scipy.sparse import csr_matrix

    u = np.minimum(src, dst).astype(np.int64)
    v = np.maximum(src, dst).astype(np.int64)
    ok = u != v
    cand = np.unique((u[ok] << 32) | v[ok])
    dropped = cand[~np.isin(cand, keys)]
    rng = np.random.default_rng(seed)
    pick = dropped if len(dropped) <= sample else rng.choice(dropped, sample, replace=False)
    su, sv = keys >> 32, keys & 0xFFFFFFFF
    s = csr_matrix((np.ones(2 * len(su), np.int32), (np.concatenate([su, sv]),
                                                     np.concatenate([sv, su]))), shape=(n, n))
    rows_u, rows_v = s[pick >> 32], s[pick & 0xFFFFFFFF]
    two = np.asarray(rows_u.multiply(rows_v).sum(axis=1)).ravel()
    three = np.asarray((rows_u @ s).multiply(rows_v).sum(axis=1)).ravel()
    return len(dropped), len(pick), int(np.sum((two == 0) & (three == 0)))


def phase_spanner_k3(torch, smi):
    """(b) The reference's ``spanner_k3_eps`` cell at its own size, through
    the kernel: the counted main-path run (its host syncs in the window
    loop counted, each window's first search captured for (a)), (a), the
    edges/s, the 3-hop check on a sample of the dropped edges, the
    profile's step table with both bound shares, and the kernel's row of
    the ``kernels`` line."""
    from gelly_streaming_tpu_torch.library import spanner as tsp
    from gelly_streaming_tpu_torch.ops import reach_kernels as rk

    src, dst = make_stream(SP_VERTICES, SP_EDGES, seed=SP_SEED)

    def run():
        return _spanner_run(src, dst, SPK3_K, SP_WINDOW, SP_VERTICES, expected=SP_EDGES)

    def one_pass():
        sp, it = run()
        n = sum(1 for _ in it)
        sp.sync()
        return n

    # the main path, counted: the wrapper's launches from 0 and the host
    # syncs of the window loop, each window's first search's operands kept
    # (a new CSR starts a window)
    captured, by_csr = [], {}

    def capture(csr, u, v, m, nv, k):
        rec = by_csr.get(id(csr))
        if rec is None:
            rec = by_csr[id(csr)] = {"args": (csr, u, v, m, nv, k), "batches": 0, "words": 0,
                                     "q": torch.zeros((), dtype=torch.int64, device=u.device)}
            captured.append(rec)
        rec["batches"] += 1
        rec["words"] += u.shape[0] // 32
        rec["q"] = rec["q"] + m.sum()
        return rk.k_reach(csr, u, v, m, nv, k)

    stages, t_stage = {}, time.perf_counter()

    def stage(name):
        nonlocal t_stage
        now = time.perf_counter()
        stages[name] = now - t_stage
        t_stage = now

    tsp.k_reach = capture
    try:
        rk.LAUNCHES = 0
        sp, it = run()
        windows, in_loop, after = count_syncs(torch, it)
        sp.sync()
        launches = rk.LAUNCHES
    finally:
        tsp.k_reach = rk.k_reach
    batches = sum(r["batches"] for r in captured)
    for rec in captured:
        rec["s"] = int(rec["args"][0].row_ptr[-1]) // 2
        rec["q"] = int(rec["q"])
    say(f"spanner k=3 (b): {windows} windows, searches a window {[r['batches'] for r in captured]}"
        f", window-start spanner edges {[r['s'] for r in captured]}, search launches {launches} "
        f"(expected one a search, {batches})")
    if launches == 0 or launches != batches or len(captured) != windows - 1:
        raise AssertionError("the k = 3 cell did not search windows 1-3 through the search kernel")
    kept = _spanner_edges(sp)
    del sp, it
    stage("counted_run")
    cases = phase_k_reach_checks(torch, captured)
    stage("checks_a")
    cell = timed_passes(torch, one_pass, SP_EDGES)
    stage("timed_passes")
    cell.update(host_syncs_in_loop=in_loop, host_syncs_after_loop=after, kept=int(len(kept)),
                launches=launches, searches=batches, kernel_cases=cases,
                window_start_edges=[r["s"] for r in captured])
    t0 = time.perf_counter()
    dropped, sampled, bad = spanner_check_3hops(src, dst, kept, SP_VERTICES, SPK3_SAMPLE,
                                                SPK3_SAMPLE_SEED)
    cell.update(dropped=dropped, sampled=sampled, sampled_without_3hop_path=bad)
    stage("check_3hops")
    say("spanner k=3 (b) cell " + json.dumps(cell))
    say(f"spanner k=3 (b): {len(kept)} edges kept, {dropped} dropped; of {sampled} sampled, "
        f"{bad} without a path of at most 3 hops ({time.perf_counter() - t0:.1f} s)")
    if in_loop != 0 or windows != SP_EDGES // SP_WINDOW:
        raise AssertionError("the k = 3 spanner read the device in its window loop")
    if bad:
        raise AssertionError("the k = 3 device spanner dropped an edge with no 3-hop path")

    # the step table over the cell's first SPK3_PROFILE_WINDOWS windows
    # (window 0 appends, the rest search): bound per window over them
    pw = SPK3_PROFILE_WINDOWS

    def profiled_pass():
        sp_, it_ = _spanner_run(src[:pw * SP_WINDOW], dst[:pw * SP_WINDOW], SPK3_K, SP_WINDOW,
                                SP_VERTICES, expected=SP_EDGES)
        n_ = sum(1 for _ in it_)
        sp_.sync()
        return n_

    u0 = np.minimum(src[:SP_WINDOW], dst[:SP_WINDOW]).astype(np.int64)
    v0 = np.maximum(src[:SP_WINDOW], dst[:SP_WINDOW]).astype(np.int64)
    q0 = len(np.unique((u0 << 32 | v0)[u0 != v0]))
    per = [k_reach_bytes(r["s"], r["q"], SP_VERTICES) for r in captured[:pw - 1]]
    nbytes = {name: sum(d[name] for d in per) / pw for name in per[0]}
    nbytes["spanner.append"] += 9 * q0 / pw
    prof = profile_cell(torch, f"spanner k=3 (b), windows 0-{pw - 1}", profiled_pass, SP3_STEPS,
                        nbytes, foreign=SP3_FOREIGN)
    frontier = sum(k_reach_frontier_bytes(SPK3_K, r["s"], SP_VERTICES, r["words"])
                   for r in captured[:pw - 1]) / pw
    step = prof["steps"].get("spanner.k_reach", {})
    span = prof["host_spans"].get("spanner.k_reach", {})
    step["host_ms_a_search"] = span["host_ms"] / span["calls"] if span.get("calls") else None
    step["frontier_bound_ms"] = frontier / HBM_BYTES_PER_S * 1e3
    step["frontier_bound_share"] = (step["frontier_bound_ms"] / step["device_ms"]
                                    if step.get("device_ms") else None)
    say("spanner k=3 (b) spanner.k_reach a window " + json.dumps(step))
    cell["profile"] = prof
    stage("profile")

    # the kernel's row: one search on window 3's first batch, cold L2, the
    # search twice, in turns with the other forms
    rec = captured[-1]
    csr, u, v, m, nv, k = rec["args"]
    w = u.shape[0] // 32
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=u.device)
    fronts, bitmaps = rk._scratch(u.device, nv, w)
    out = torch.empty_like(m)
    lead = KR_LEAD_CYCLES
    search = lambda: rk.k_reach(csr, u, v, m, nv, k)  # noqa: E731
    turns = {"ms": [cold_ms(torch, search, flush, lead_cycles=lead)]}
    row = {
        "device_bitmap_ms": cold_ms(
            torch, lambda: rk._launch(csr.row_ptr, csr.src, u, v, m, fronts, bitmaps, out, nv, w,
                                      k, device_bitmap=True), flush, lead_cycles=lead),
        "plain_ms": cold_ms(torch, lambda: rk.k_reach_plain(csr, u, v, m, nv, k), flush,
                            iters=5, warmup=1, lead_cycles=lead),
    }
    turns["ms"].append(cold_ms(torch, search, flush, lead_cycles=lead))
    if not (torch.equal(out, search()) and not fronts.any() and not bitmaps.any()):
        raise AssertionError("the search with its bitmap in device memory disagrees, or the "
                             "scratch was left dirty")
    del flush
    for name, pair in turns.items():
        row[name] = sum(pair) / 2
        row[name + "_turns"] = pair
    row["bound_ms"], row["bound_by"] = k_reach_call_bound(rec["s"], nv, u.shape[0], k)
    row["frontier_bound_ms"] = (k_reach_frontier_bytes(k, rec["s"], nv, w)
                                / HBM_BYTES_PER_S * 1e3)
    active = k_reach_active_traffic(csr, u, m, nv, k)
    row["active"] = active
    row["active_bound_ms"] = active["bytes"] / HBM_BYTES_PER_S * 1e3
    row["bound_share"] = row["bound_ms"] / row["ms"]
    row["frontier_bound_share"] = row["frontier_bound_ms"] / row["ms"]
    row["active_bound_share"] = row["active_bound_ms"] / row["ms"]
    row["per"] = (f"one search of window 3's first batch: B = {u.shape[0]}, S = {rec['s']}, "
                  f"V = {nv}, k = {k}, cold L2; {smi}")
    say("k_reach time (cold L2, median of each call alone) " + json.dumps(row))
    if row["bound_share"] > 1.0:
        raise AssertionError("the search ran faster than its bound: the timing is wrong")
    cell["kernel_row"] = row
    stage("timings")
    say("spanner k=3 (b) seconds by stage " + json.dumps(stages))
    return cell


# --------------------------------------------------------------------- #
# Slice 5b: the device vertex dictionary, the estimators, iterative CC
# --------------------------------------------------------------------- #
def dict_encode_bytes(n, kcap):
    """Bytes of one ``dict.encode`` of a window of ``n`` edges into a table
    of ``kcap`` keys: the raw src and dst columns read and their compact
    ids written (int32), the table's keys, ids and reverse table read once
    and written once (int32 each)."""
    return 8 * n + 8 * n + 12 * kcap + 12 * kcap


def _de_stream(path, form, prefetch=2):
    from gelly_streaming_tpu_torch import CountWindow, datasets

    bound = form == "id_bound"
    return datasets.stream_file(
        path, window=CountWindow(CC_WINDOW), device_encode=True,
        min_vertex_capacity=CC_ID_BOUND if bound else DE_HINT, dense_ids=bound,
        prefetch_depth=prefetch, device="cuda",
    )


def _de_pass(torch, path, form, prefetch=2):
    """One pass of ``bench_cc_e2e_device`` (``id_bound``: the binary cache)
    or ``bench_cc_e2e_device_text`` (``growth``: the text file), ``sync()``
    inside the timed region."""
    from gelly_streaming_tpu_torch.library import ConnectedComponents
    from gelly_streaming_tpu_torch.ops import cc_kernels, device_dict
    from gelly_streaming_tpu_torch.summaries import labels

    stream = _de_stream(path, form, prefetch)
    agg = ConnectedComponents()
    labels.HOST_READS = labels.FIXPOINT_TURNS = 0
    device_dict.ENCODES = 0
    cc_kernels.LAUNCHES = 0
    lat, last = [], None
    t0 = last_t = time.perf_counter()
    for last in stream.aggregate(agg):
        now = time.perf_counter()
        lat.append(now - last_t)
        last_t = now
    agg.sync()
    dt = time.perf_counter() - t0
    lat_ms = np.asarray(lat) * 1e3
    n_win = len(lat)
    return {
        "windows": n_win, "seconds": dt,
        "p50_ms": float(np.percentile(lat_ms, 50)), "p95_ms": float(np.percentile(lat_ms, 95)),
        "carry": agg._cc_mode, "encodes": device_dict.ENCODES,
        "host_reads_per_window": labels.HOST_READS / n_win,
        "cc_fold_launches_per_window": cc_kernels.LAUNCHES / n_win,
        "table_capacity": stream.vertex_dict.capacity,
    }, last, stream


def _raw_partition_ok(last, vdict, want, seen):
    """:func:`_raw_partition` as one verdict: ``(exact, seen, components)``."""
    same, bad, n_comp = _raw_partition(last, vdict, want, seen)
    return same and bad == 0, len(seen), n_comp


def phase_device_encode(torch):
    from torch.profiler import ProfilerActivity, profile

    from gelly_streaming_tpu_torch import CountWindow, datasets, native
    from gelly_streaming_tpu_torch.core.vertexdict import VertexDict
    from gelly_streaming_tpu_torch.obs import trace

    path, _ = datasets.ensure_corpus(CC_CORPUS)
    spec = datasets.CORPORA[CC_CORPUS]
    n_edges = spec.surrogate_edges
    bin_path = datasets.binary_cache(path)
    src, dst = rmat_oracle_edges(n_edges, int(spec.surrogate_vscale).bit_length() - 1)
    want = oracle_labels(src, dst, CC_ID_BOUND)
    seen = np.unique(np.concatenate([src, dst]))
    cells = {}
    for form, fpath in (("id_bound", bin_path), ("growth", path)):
        warm, _, _ = _de_pass(torch, fpath, form)
        passes = [_de_pass(torch, fpath, form) for _ in range(CC_STEADY_PASSES)]
        results = [p[0] for p in passes]
        for r in results:
            r["edges_per_s"] = n_edges / r["seconds"]
        mid = sorted(range(len(results)), key=lambda i: results[i]["edges_per_s"])[1]
        cell = dict(results[mid])
        cell["edges_per_s_all"] = [r["edges_per_s"] for r in results]
        cell["warm_seconds"] = warm["seconds"]
        if cell["windows"] != n_edges // CC_WINDOW or cell["encodes"] != cell["windows"]:
            raise AssertionError(f"device-encode {form}: {cell['windows']} windows, "
                                 f"{cell['encodes']} encodes")
        # the dense carry's fold: one launch and no host read a window
        folds = [r["cc_fold_launches_per_window"] for r in results]
        if any(f != 1.0 for f in folds) or cell["host_reads_per_window"] != 0:
            raise AssertionError(f"device-encode {form}: {folds} fold launches and "
                                 f"{cell['host_reads_per_window']} host reads a window")
        # correctness: the last window's partition in raw ids against scipy
        last, stream = passes[mid][1], passes[mid][2]
        vd = stream.vertex_dict
        t1 = time.perf_counter()
        ok, n_seen, n_comp = _raw_partition_ok(last, vd, want, seen)
        probe = int(vd._state["probe"])
        cell.update(components=n_comp, vertices_seen=n_seen, probe=probe)
        say(f"device-encode {form} vs scipy (last window, {n_seen} vertices): components "
            f"{n_comp}, {'exact' if ok else 'FAIL'}; probe {probe} "
            f"({time.perf_counter() - t1:.1f} s)")
        if not ok or probe < 0 or probe != n_seen:
            raise AssertionError(f"device-encode {form} disagrees with scipy or overflowed")
        # window 0's compact ids against the port's host VertexDict
        b0 = next(iter(_de_stream(fpath, form, prefetch=0).blocks()))
        hs, hd = VertexDict().encode_pair(src[:CC_WINDOW], dst[:CC_WINDOW])
        same0 = (np.array_equal(b0.src[:CC_WINDOW].cpu().numpy(), hs)
                 and np.array_equal(b0.dst[:CC_WINDOW].cpu().numpy(), hd))
        # host syncs of the ingest's window loop (parse, upload, encode)
        n, in_loop, after = count_syncs(torch, _de_stream(fpath, form, prefetch=0).blocks())
        cell.update(window0_ids_equal_host_dict=same0, host_syncs_in_loop=in_loop,
                    host_syncs_after_loop=after)
        say(f"device-encode {form} cell " + json.dumps(cell))
        if not same0 or in_loop != 0 or n != cell["windows"]:
            raise AssertionError(f"device-encode {form}: window 0 ids equal {same0}, "
                                 f"{in_loop} host syncs in the ingest loop")
        # where the time goes: one profiled pass on the main thread (no
        # prefetch: the producer thread's ranges are not in the profile)
        trace.enable(torch_annotations=True)
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t2 = time.perf_counter()
                r, _, st = _de_pass(torch, fpath, form, prefetch=0)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t2
        finally:
            trace.disable()
        say(f"device-encode {form} profile ({r['windows']} windows, no prefetch, "
            f"{wall * 1e3:.1f} ms):")
        cell["busy_share"] = profile_pass(torch, lambda: None, wall, prof=prof)
        vcap = st.vertex_dict.capacity
        steps = step_rows(prof, DE_STEPS, r["windows"],
                          {"dict.encode": dict_encode_bytes(CC_WINDOW, vcap),
                           "engine.dispatch": cc_fold_bytes(CC_WINDOW, vcap)})
        # the fold's ctypes launch sits under no PyTorch operation: credit it
        # to its range by name
        captured = _captured_kernels(prof, DE_FOREIGN)
        _add_foreign_kernels(steps, DE_FOREIGN, captured, r["windows"])
        cell["trace_fold_launches"] = captured["engine.dispatch"][0]
        cell["counted_fold_launches"] = round(r["cc_fold_launches_per_window"] * r["windows"])
        say(f"device-encode {form} steps (device ms, launches and bytes' bound per window; "
            "dict.encode and engine.dispatch bounds at the final table capacity) "
            + json.dumps(steps))
        cell["steps"] = steps
        cells[form] = cell
        del passes

    # sparse arbitrary int32 ids: the corpus's first windows through an
    # injective affine map mod 2^31 - 1, against the host dict
    m = DE_SPARSE_WINDOWS * CC_WINDOW
    ms = (src[:m] * 48271 + 12345) % DE_SPARSE_PRIME
    md = (dst[:m] * 48271 + 12345) % DE_SPARSE_PRIME
    sparse_path = os.path.join(os.path.dirname(path), "smoke_sparse_ids.txt")
    native.write_edge_file(sparse_path, ms, md)
    stream = datasets.stream_file(sparse_path, window=CountWindow(CC_WINDOW), device_encode=True,
                                  dense_ids=False, min_vertex_capacity=DE_HINT, device="cuda")
    host = VertexDict()
    ok = True
    for i, b in enumerate(stream.blocks()):
        a, z = i * CC_WINDOW, (i + 1) * CC_WINDOW
        hs, hd = host.encode_pair(ms[a:z], md[a:z])
        ok &= (np.array_equal(b.src[:CC_WINDOW].cpu().numpy(), hs)
               and np.array_equal(b.dst[:CC_WINDOW].cpu().numpy(), hd))
    vd = stream.vertex_dict
    ok &= np.array_equal(vd.raw_ids(), host.raw_ids())
    say(f"device-encode sparse int32 ids ({m} edges, {len(host)} ids up to "
        f"{int(max(ms.max(), md.max()))}, table {vd.capacity}): "
        f"{'equal to the host dict' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the device dictionary disagrees with the host dict on sparse ids")
    os.remove(sparse_path)
    return cells


def _simple_stream(n_vertices, n_edges, seed):
    """``make_stream`` made duplicate-free and loop-free: each canonical
    pair's first arrival."""
    src, dst = make_stream(n_vertices, n_edges, seed=seed)
    s, d = src.astype(np.int64), dst.astype(np.int64)
    key = np.where(s != d, np.minimum(s, d) * n_vertices + np.maximum(s, d), -1)
    _, first = np.unique(key, return_index=True)
    first = np.sort(first[key[first] >= 0])
    return src[first], dst[first]


def exact_triangles(src, dst, n):
    """scipy: triangles of the simple graph, with edges oriented from the
    lower (degree, id) rank to the higher, as ``sum((L @ L) * L)``."""
    from scipy.sparse import csr_matrix

    s, d = src.astype(np.int64), dst.astype(np.int64)
    deg = np.bincount(np.concatenate([s, d]), minlength=n)
    rank = np.empty(n, np.int64)
    rank[np.lexsort((np.arange(n), deg))] = np.arange(n)
    up = rank[s] < rank[d]
    a, b = np.where(up, s, d), np.where(up, d, s)
    lo = csr_matrix((np.ones(len(a)), (a, b)), shape=(n, n))
    return int(round((lo @ lo).multiply(lo).sum()))


def cc_fold_bytes(e, v):
    """Bytes of one window's fold into a ``v``-label table: the int32
    columns (8e) and the mask (e) read, the carried labels read and the new
    ones written (8v), the touched flags read and written (2v)."""
    return 9 * e + 10 * v


def sampling_window_bytes(e, k):
    """Bytes of one vectorized window update: the window's src, dst (int32)
    and mask read; the three [k] uniforms read; the sample columns (three
    int32, two bool) read and written."""
    return 9 * e + 12 * k + 2 * 14 * k


def sampling_scan_bytes(e, k):
    """Bytes the scan of ``e`` edges through ``k`` samples must move: the
    two ``[e, k]`` float32 uniforms and the int32 edge columns read once,
    the sample columns (three int32, two bool) read once and written once.
    The step's work needs the state only once: the torch form read and
    wrote it every edge, which a kernel keeping it in registers does not,
    so that traffic is the form's, not the work's."""
    return 8 * e * k + 8 * e + 28 * k


def sampling_scan_closed_bytes(e, k):
    """Bytes the scan's closed form must move: a sample's state after a
    batch depends on its last replacement alone, so the ``[e, k]`` coins
    are read once, the third draws only there (``k`` of them), the int32
    edge columns once, the sample columns read and written once."""
    return 4 * e * k + 8 * e + 32 * k


def _recording(cls, device):
    """An estimator class that records its uniforms and its state after
    every window (``replay`` feeds recorded uniforms back instead)."""

    class Recording(cls):
        def __init__(self, *a, replay=None, **kw):
            super().__init__(*a, device=device, **kw)
            self.drawn = [] if replay is None else list(replay)
            self.replay = replay is not None
            self.states = []

        def _draw(self, *shape):
            if self.replay:
                return self.drawn.pop(0).to(self.device)
            u = super()._draw(*shape)
            self.drawn.append(u.cpu())
            return u

        def _window(self, block, vdict):
            n = super()._window(block, vdict)
            self.states.append({f: v.cpu().numpy() for f, v in self._state.items()})
            return n

    return Recording


def _states_equal(a, b):
    return len(a) == len(b) and all(
        all(np.array_equal(x[f], y[f]) for f in x) for x, y in zip(a, b))


def _ccf_stream(torch):
    """The fold's stream on the card (the benchmark's generator): R-MAT ids
    relabelled to compact ids in the order of first appearance (edge by
    edge, source before target), as the device dictionary numbers them."""
    from graphbench.generate import rmat

    dev = torch.device("cuda")
    n, v = CCF_WINDOW * CCF_WINDOWS, 1 << CCF_SCALE
    src, dst = (c.long() for c in rmat(n, CCF_SCALE, 0.57, 0.19, 0.19, CCF_SEED, dev))
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    first = torch.full((v,), 2 * n, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, src, 2 * pos, "amin")
    first.scatter_reduce_(0, dst, 2 * pos + 1, "amin")
    del pos
    rank = torch.empty(v, dtype=torch.int64, device=dev)
    rank[torch.argsort(first)] = torch.arange(v, dtype=torch.int64, device=dev)
    return rank[src].to(torch.int32), rank[dst].to(torch.int32), v


def phase_cc_fold(torch, smi=None):
    """The dense carry's window fold at the CC cell's shapes: every window
    of the stream through the kernel, each between its own CUDA events (the
    table warm in L2 from the window before, as in the stream), bit-equal to
    the plain composition at every ``CCF_PLAIN_EVERY``-th window, where the
    plain composition is timed too; one mid-stream window with a cold L2;
    and a worst case, a 2^20-edge path fed in reverse (one chain of 2^20
    hooks)."""
    from gelly_streaming_tpu_torch.ops import cc_kernels
    from gelly_streaming_tpu_torch.summaries import labels

    src, dst, v = _ccf_stream(torch)
    mask = torch.ones(CCF_WINDOW, dtype=torch.bool, device="cuda")
    state = labels.init_labels(v, "cuda")
    launches = cc_kernels.LAUNCHES
    cc_kernels.fold_window(state["labels"], state["touched"], src[:CCF_WINDOW],
                           dst[:CCF_WINDOW], mask)  # the build and the first launch
    torch.cuda.synchronize()
    pairs, plain, equal, mid = [], [], [], None
    lab, tch = state["labels"], state["touched"]
    for w in range(CCF_WINDOWS):
        s, d = src[w * CCF_WINDOW:(w + 1) * CCF_WINDOW], dst[w * CCF_WINDOW:(w + 1) * CCF_WINDOW]
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = cc_kernels.fold_window(lab, tch, s, d, mask)
        end.record()
        pairs.append((start, end))
        if w % CCF_PLAIN_EVERY == CCF_PLAIN_EVERY - 1:
            torch.cuda.synchronize()
            p0, p1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            reads = labels.HOST_READS
            t0 = time.perf_counter()
            p0.record()
            want = cc_kernels.fold_window_plain(lab, tch, s, d, mask)
            p1.record()
            torch.cuda.synchronize()
            plain.append({"window": w, "device_ms": p0.elapsed_time(p1),
                          "host_ms": (time.perf_counter() - t0) * 1e3,
                          "host_reads": labels.HOST_READS - reads})
            equal.append(bool(torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])))
        if w == CCF_WINDOWS // 2:
            mid = (lab, tch, s, d)
        lab, tch = out
    torch.cuda.synchronize()
    launched = cc_kernels.LAUNCHES - launches
    ms = [a.elapsed_time(b) for a, b in pairs]
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")
    cold = cold_ms(torch, lambda: cc_kernels.fold_window(*mid, mask), flush)
    bound_ms = cc_fold_bytes(CCF_WINDOW, v) / HBM_BYTES_PER_S * 1e3
    seen = int(tch.sum())
    comps = int((lab[tch] == torch.arange(v, device="cuda")[tch]).sum())
    row = {
        "name": "cc_fold_window", "smi": smi, "per": f"window: E = {CCF_WINDOW}, V = {v}",
        "ms_mean": statistics.fmean(ms), "ms_median": statistics.median(ms),
        "ms_first": ms[0], "ms_max": max(ms), "cold_ms": cold,
        "bound_ms": bound_ms, "bound_by": "bytes (8E + E + 8V + 2V)",
        "bound_share_mean": bound_ms / statistics.fmean(ms),
        "plain": plain, "plain_device_ms_mean": statistics.fmean(p["device_ms"] for p in plain),
        "plain_host_ms_mean": statistics.fmean(p["host_ms"] for p in plain),
        "library_ms": None, "equal_to_plain": equal,
        "launches": launched, "vertices_seen": seen, "components": comps,
    }
    # the worst case: one reversed path of CCF_WINDOW hooks into a fresh table
    i = torch.arange(CCF_WINDOW - 1, -1, -1, dtype=torch.int32, device="cuda")
    fresh = labels.init_labels(v, "cuda")
    path_args = (fresh["labels"], fresh["touched"], i, i + 1, mask)
    row["reverse_path_ms"] = cuda_ms(torch, lambda: cc_kernels.fold_window(*path_args),
                                     iters=3, warmup=1)
    got = cc_kernels.fold_window(*path_args)[0]
    row["reverse_path_flat_and_one_component"] = bool(
        (got[: CCF_WINDOW + 1] == 0).all() and torch.equal(got[CCF_WINDOW + 1:],
                                                           fresh["labels"][CCF_WINDOW + 1:]))
    say("cc fold kernel " + json.dumps(row))
    if not all(equal) or not row["reverse_path_flat_and_one_component"]:
        raise AssertionError("cc fold: the kernel disagrees with the plain composition")
    if launched != CCF_WINDOWS + 1:
        raise AssertionError(f"cc fold: {launched} launches for {CCF_WINDOWS + 1} folds")
    return row


def phase_sampling(torch):
    from gelly_streaming_tpu_torch import CountWindow
    from gelly_streaming_tpu_torch.library import sampling

    src, dst = _simple_stream(SMP_VERTICES, SMP_EDGES, SMP_SEED)
    m, v = len(src), SMP_VERTICES
    t0 = time.perf_counter()
    tri = exact_triangles(src, dst, v)
    p = tri / (m * (v - 2))
    k = 1
    while k * p < SMP_TARGET_BETA and k < SMP_MAX_K:
        k *= 2
    say(f"sampling stream: {m} distinct edges over {v} vertices, {tri} triangles (scipy, "
        f"{time.perf_counter() - t0:.1f} s); k = {k} samples, E[beta_sum] = {k * p:.1f}")
    edges = (src, dst)
    cls = _recording(sampling.BroadcastTriangleCount, "cuda")

    def run(c=cls, **kw):
        est = c(vertex_count=v, samples=k, window=CountWindow(SMP_WINDOW), seed=SMP_SEED, **kw)
        out = list(est.run(edges))
        torch.cuda.synchronize()
        return est, out

    def one_pass():
        # the plain estimator: no recording, no per-window copies
        run(sampling.BroadcastTriangleCount, device="cuda")
        return -(-m // SMP_WINDOW)

    cell = timed_passes(torch, one_pass, m)
    est, out = run()
    se = m * (v - 2) / k * np.sqrt(k * p * (1 - p))
    final = out[-1][1] if out else 0
    cell.update(samples=k, triangles=tri, estimate=final, beta=est._last_beta,
                standard_error=se, emissions=len(out))
    ok = abs(final - tri) <= SMP_SE * se and out[-1][0] == m
    say(f"sampling estimate {final} against {tri} (scipy): {abs(final - tri) / se:.2f} "
        f"standard errors, {'within' if ok else 'OUTSIDE'} {SMP_SE}")
    if not ok:
        raise AssertionError("the triangle estimate is outside its bound")
    # every window's state against the CPU fed the same uniforms
    t1 = time.perf_counter()
    cpu = _recording(sampling.BroadcastTriangleCount, "cpu")
    est_c, out_c = run(cpu, replay=est.drawn)
    same = _states_equal(est.states, est_c.states) and out == out_c
    inc, out_i = run(_recording(sampling.IncidenceSamplingTriangleCount, "cuda"))
    same_i = out_i == out and _states_equal(inc.states, est.states)
    say(f"sampling vectorized: {len(est.states)} windows equal to the CPU fed the same "
        f"uniforms: {same} ({time.perf_counter() - t1:.1f} s); the incidence estimator "
        f"equal: {same_i}")
    if not (same and same_i):
        raise AssertionError("the vectorized estimator on the card disagrees with the CPU")

    # the scan form: an id space above the vectorized limit
    from gelly_streaming_tpu_torch.ops import sampling_kernels as sk

    ss, sd = src[:SMP_SCAN_EDGES], dst[:SMP_SCAN_EDGES]

    def scan_run(c, **kw):
        e = c(vertex_count=SMP_SCAN_VERTICES, samples=SMP_SCAN_K,
              window=CountWindow(SMP_SCAN_EDGES), seed=SMP_SEED, **kw)
        t = time.perf_counter()
        o = list(e.run((ss, sd)))
        torch.cuda.synchronize()
        return e, o, time.perf_counter() - t

    scan_run(cls)  # warm
    sk.LAUNCHES = 0
    es, os_, secs = scan_run(cls)
    launches = sk.LAUNCHES
    ec, oc, _ = scan_run(_recording(sampling.BroadcastTriangleCount, "cpu"), replay=es.drawn)
    same_s = _states_equal(es.states, ec.states) and os_ == oc
    # the plain version on the card, on the same edges and uniforms
    ids = [torch.from_numpy(a.astype(np.int32)).cuda() for a in (ss, sd)]
    uniforms = [u.cuda() for u in es.drawn]
    state0 = sampling.init_sampler_state(SMP_SCAN_K, "cuda")
    sk.reservoir_scan_plain(state0, 0, *ids, SMP_SCAN_VERTICES, *uniforms)  # warm
    torch.cuda.synchronize()
    t = time.perf_counter()
    plain, _ = sk.reservoir_scan_plain(state0, 0, *ids, SMP_SCAN_VERTICES, *uniforms)
    torch.cuda.synchronize()
    plain_secs = time.perf_counter() - t
    same_p = all(np.array_equal(plain[f].cpu().numpy(), es.states[-1][f]) for f in plain)
    del uniforms
    cell["scan"] = {"edges": SMP_SCAN_EDGES, "vertex_count": SMP_SCAN_VERTICES,
                    "samples": SMP_SCAN_K, "ms_per_edge": secs * 1e3 / SMP_SCAN_EDGES,
                    "plain_ms_per_edge": plain_secs * 1e3 / SMP_SCAN_EDGES,
                    "kernel_launches": launches, "equal_to_cpu": same_s,
                    "plain_on_card_equal": same_p}
    say("sampling scan " + json.dumps(cell["scan"]))
    if not (same_s and same_p and launches == 1):
        raise AssertionError("the scan estimator on the card disagrees with the CPU or with "
                             "the plain version, or did not launch the kernel once")
    say("sampling cell " + json.dumps({f: x for f, x in cell.items() if f != "profile"}))
    cell["profile"] = profile_cell(torch, "sampling", one_pass, SMP_STEPS,
                                   {"sampling.window": sampling_window_bytes(SMP_WINDOW, k)})

    def scan_pass():
        scan_run(sampling.BroadcastTriangleCount, device="cuda")
        return 1

    cell["profile_scan"] = profile_cell(
        torch, "sampling scan", scan_pass, ("sampling.scan",),
        {"sampling.scan": sampling_scan_closed_bytes(SMP_SCAN_EDGES, SMP_SCAN_K)},
        foreign=SMP_FOREIGN)
    cell["scan_full"] = _scan_full_pass(torch, edges, tri)
    return cell


def _scan_batches(m, window, k):
    """Each draw batch's edges over a stream of ``m`` edges in windows of
    ``window``: ``library/sampling.py``'s ``_SCAN_DRAW_ELEMS // k`` a batch."""
    from gelly_streaming_tpu_torch.library import sampling

    step = max(1, sampling._SCAN_DRAW_ELEMS // k)
    out = []
    for a in range(0, m, window):
        w = min(window, m - a)
        out += [min(step, w - b) for b in range(0, w, step)]
    return out


def _scan_full_pass(torch, edges, tri):
    """Phase 14 (b)-(c): the whole stream through the scan route (vertex
    count ``SMP_SCAN_VERTICES``, ``SMP_SCAN_FULL_K`` samples, windows of
    ``SMP_WINDOW``), its checks, and the kernel's row: the kernel against
    the plain version on window 0's first ``SMP_SCAN_CHECK_EDGES`` edges,
    then one draw batch timed cold in turns with the plain version and the
    two draws."""
    from gelly_streaming_tpu_torch import CountWindow
    from gelly_streaming_tpu_torch.library import sampling
    from gelly_streaming_tpu_torch.ops import sampling_kernels as sk

    m, v, k = len(edges[0]), SMP_SCAN_VERTICES, SMP_SCAN_FULL_K
    batches = _scan_batches(m, SMP_WINDOW, k)
    windows = -(-m // SMP_WINDOW)

    class Counted(sampling.BroadcastTriangleCount):
        draws = 0

        def _draw(self, *shape):
            Counted.draws += 1
            return super()._draw(*shape)

    def run(c=sampling.BroadcastTriangleCount):
        est = c(vertex_count=v, samples=k, window=CountWindow(SMP_WINDOW), seed=SMP_SEED,
                device="cuda")
        out = list(est.run(edges))
        torch.cuda.synchronize()
        return est, out

    def one_pass():
        run()
        return windows

    full = timed_passes(torch, one_pass, m)
    full["sample_steps_per_s"] = full["edges_per_s"] * k
    # the counted run: the main path with the counts at 0
    sk.LAUNCHES = 0
    Counted.draws = 0
    est = Counted(vertex_count=v, samples=k, window=CountWindow(SMP_WINDOW), seed=SMP_SEED,
                  device="cuda")
    with warnings.catch_warnings(record=True) as log:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = list(est.run(edges))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    launches, draws = sk.LAUNCHES, Counted.draws
    full.update(samples=k, vertex_count=v, batches=len(batches), kernel_launches=launches,
                kernel_launches_per_window=launches / windows, draws_per_window=draws / windows,
                host_reads_per_window=_n_syncs(log) / windows)
    p = tri / (m * (v - 2))
    se = m * (v - 2) / k * np.sqrt(k * p * (1 - p))
    final = out[-1][1] if out else 0
    full.update(triangles=tri, estimate=final, beta=est._last_beta, standard_error=se,
                expected_beta=k * p, emissions=len(out))
    inc, out_i = run(sampling.IncidenceSamplingTriangleCount)
    same_i = out_i == out and all(torch.equal(inc._state[f], est._state[f]) for f in est._state)
    full["incidence_equal"] = same_i
    say("sampling scan full pass " + json.dumps(full))
    say(f"sampling scan estimate {final} against {tri} (scipy): {abs(final - tri) / se:.2f} "
        f"standard errors at p = T / (m (V - 2)) = {p:.3e}")
    if launches != len(batches) or draws != 2 * len(batches):
        raise AssertionError(f"the scan pass made {launches} kernel launches and {draws} draws "
                             f"for {len(batches)} batches")
    if not (abs(final - tri) <= SMP_SE * se and est._edge_count == m):
        raise AssertionError("the scan pass's estimate is outside its bound")
    if not same_i:
        raise AssertionError("the incidence estimator's scan disagrees with the broadcast one")
    del est, inc

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SMP_SEED)
    n = SMP_SCAN_CHECK_EDGES
    uc = torch.rand((n, k), generator=gen, device="cuda")
    ut = torch.rand((n, k), generator=gen, device="cuda")
    s, d = (torch.from_numpy(a[:n].astype(np.int32)).cuda() for a in edges)
    state0 = sampling.init_sampler_state(k, "cuda")
    got, _ = sk.reservoir_scan(state0, 0, s, d, v, uc, ut)
    want, _ = sk.reservoir_scan_plain(state0, 0, s, d, v, uc, ut)
    err = max(float((got[f].long() - want[f].long()).abs().max()) for f in got)
    say(f"sampling reservoir_scan vs reservoir_scan_plain on window 0's first {n} edges at "
        f"k = {k}: max abs difference {err} (tol 0: equal bit for bit); beta "
        f"{int((got['src_found'] & got['trg_found']).sum())}")
    if err != 0:
        raise AssertionError("the reservoir scan kernel disagrees with its plain version")
    # one draw batch of the main path, after the checked edges
    b = batches[0]
    args = (got, n, s[:b], d[:b], v, uc[:b], ut[:b])
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")

    def kernel():
        return sk.reservoir_scan(*args)

    def plain():
        return sk.reservoir_scan_plain(*args)

    def draws_fn():
        return (torch.rand((b, k), generator=gen, device="cuda"),
                torch.rand((b, k), generator=gen, device="cuda"))

    def coins_read():
        # a yardstick, not the function: one streaming read of the coins
        return torch.amax(uc[:b])

    turns = {"ms": [], "plain_ms": [], "draws_ms": [], "coins_read_ms": []}
    for name in ("ms", "plain_ms", "draws_ms", "coins_read_ms", "coins_read_ms", "draws_ms",
                 "plain_ms", "ms"):
        fn = {"ms": kernel, "plain_ms": plain, "draws_ms": draws_fn,
              "coins_read_ms": coins_read}[name]
        # the plain version takes most of a second a call (launch-bound)
        iters, warmup = (3, 1) if name == "plain_ms" else (TIMED_LAUNCHES, 3)
        turns[name].append(cold_ms(torch, fn, flush, iters=iters, warmup=warmup,
                                   lead_cycles=KR_LEAD_CYCLES))
    del flush, uc, ut
    bytes_ms = sampling_scan_closed_bytes(b, k) / HBM_BYTES_PER_S * 1e3
    # the edge-by-edge form's rule: both uniform matrices read whole
    edge_by_edge_ms = sampling_scan_bytes(b, k) / HBM_BYTES_PER_S * 1e3
    # a float32 compare a sample-step (the product only where a coin came up)
    ops_ms = b * k / PEAK_OPS_PER_S["float32"] * 1e3
    row = {f: sum(x) / len(x) for f, x in turns.items()}
    row.update({f + "_turns": x for f, x in turns.items()})
    row.update(max_abs_err=err, bound_ms=max(bytes_ms, ops_ms),
               bound_by="bytes" if bytes_ms >= ops_ms else "operations", ops_bound_ms=ops_ms,
               library_ms=None, launches=launches, bound_ms_edge_by_edge_rule=edge_by_edge_ms)
    row["bound_share"] = row["bound_ms"] / row["ms"]
    row["bound_share_edge_by_edge_rule"] = edge_by_edge_ms / row["ms"]
    row["per"] = f"one draw batch: {b} edges x {k} samples after {n} edges, V = {v}, cold L2"
    say("sampling reservoir_scan times (cold L2, median of each call alone) " + json.dumps(row))
    if row["bound_share"] > 1.0:
        raise AssertionError("the reservoir scan ran faster than its bound: the timing is wrong")
    full["kernel_row"] = row
    nbytes = sum(sampling_scan_closed_bytes(x, k) for x in batches) / windows
    full["profile"] = profile_cell(torch, "sampling scan full", one_pass, ("sampling.scan",),
                                   {"sampling.scan": nbytes}, foreign=SMP_FOREIGN)
    return full


def phase_iterative_cc(torch):
    from gelly_streaming_tpu_torch import CountWindow, SimpleEdgeStream, datasets, native
    from gelly_streaming_tpu_torch.library import IterativeConnectedComponents
    from gelly_streaming_tpu_torch.ops import cc_kernels

    src, dst = make_stream(ICC_VERTICES, ICC_EDGES, seed=ICC_SEED)
    path = os.path.join(datasets.cache_dir(), "smoke_icc.txt")
    os.makedirs(datasets.cache_dir(), exist_ok=True)
    native.write_edge_file(path, src, dst)
    n_win = ICC_EDGES // ICC_WINDOW

    def streams():
        return {
            "incremental": SimpleEdgeStream(
                (src, dst), window=CountWindow(ICC_WINDOW),
                vertex_dict=datasets.IdentityDict(ICC_VERTICES), device="cuda"),
            "diff": datasets.stream_file(
                path, window=CountWindow(ICC_WINDOW), device_encode=True,
                min_vertex_capacity=ICC_VERTICES, device="cuda"),
        }

    def one_pass(name):
        icc = IterativeConnectedComponents()
        out = []
        for batch in icc.run(streams()[name]):
            out.append(batch)
            torch.cuda.synchronize()
        return icc, out

    got, times, folds = {}, {}, {}
    for name in ("incremental", "diff"):
        one_pass(name)  # warm
        cc_kernels.LAUNCHES = 0
        t0 = time.perf_counter()
        icc, out = one_pass(name)
        times[name] = (time.perf_counter() - t0) * 1e3 / len(out)
        folds[name] = cc_kernels.LAUNCHES / len(out)
        got[name] = (icc, out)
    labels = np.full(ICC_VERTICES, -1, np.int64)
    ok = all(got[n][0]._mode == n for n in got) and len(got["diff"][1]) == n_win
    for w in range(n_win):
        a, b = got["incremental"][1][w], got["diff"][1][w]
        ok &= a == b
        labels[a._v] = a._c
        z = (w + 1) * ICC_WINDOW
        want = oracle_labels(src[:z].astype(np.int64), dst[:z].astype(np.int64), ICC_VERTICES)
        seen = np.unique(np.concatenate([src[:z], dst[:z]]))
        ok &= np.array_equal(labels[seen], want[seen]) and int((labels >= 0).sum()) == len(seen)
    cell = {"windows": n_win, "ms_per_window": times, "cc_fold_launches_per_window": folds,
            "modes": {n: got[n][0]._mode for n in got}, "emitted": [len(x) for x in got["diff"][1]],
            "equal": bool(ok)}
    say("iterative cc cell " + json.dumps(cell))
    if not ok:
        raise AssertionError("iterative CC: the paths disagree or differ from scipy")
    cell["profile"] = {
        name: profile_cell(torch, f"iterative cc {name}", lambda n=name: len(one_pass(n)[1]),
                           ICC_STEPS, {}, foreign=DE_FOREIGN)
        for name in ("incremental", "diff")
    }
    os.remove(path)
    return cell



# --------------------------------------------------------------------- #
# Durability (phase 16)
# --------------------------------------------------------------------- #
class _CkptSpans:
    """An obs span sink keeping the ``checkpoint.*`` events in order."""

    def __init__(self):
        import threading

        self.lock = threading.Lock()
        self.events = []

    def emit(self, event):
        if event["name"].startswith("checkpoint."):
            with self.lock:
                self.events.append(event)

    def take(self, name):
        with self.lock:
            return [e for e in self.events if e["name"] == name]


def _dur_streams(path, device="cuda"):
    """``make_stream(vdict)`` of the headline cell for ``AutoCheckpoint``:
    the restored dict on a resume, a fresh ``IdentityDict`` else."""
    from gelly_streaming_tpu_torch import CountWindow, datasets

    def make_stream(vdict):
        return datasets.stream_file(
            path, window=CountWindow(CC_WINDOW),
            vertex_dict=vdict if vdict is not None else datasets.IdentityDict(CC_ID_BOUND),
            prefetch_depth=2, device=device,
        )

    return make_stream


def _labels_equal(a, b):
    return np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


class _EventWindows:
    """``DegreeDistribution`` takes event records, not a stream: this
    stream stand-in yields one window of events per ``blocks()`` item, so
    ``AutoCheckpoint`` can skip the windows a barrier covers. The
    workload keeps its own vertex dict (in its ``state_dict``)."""

    vertex_dict = None

    def __init__(self, events, window):
        self.events = events
        self.window = window

    def blocks(self):
        for a in range(0, len(self.events), self.window):
            yield self.events[a:a + self.window]


class _WindowedDD:
    """A ``DegreeDistribution`` driven one window of events at a time."""

    def __init__(self, dd):
        self.dd = dd

    def state_dict(self):
        return self.dd.state_dict()

    def load_state_dict(self, d):
        self.dd.load_state_dict(d)

    def run(self, stream):
        for events in stream.blocks():
            yield from self.dd.run(events)


def _ckpt_pass(torch, make_stream, path=None, every=None):
    """One pass of the headline cell, under ``AutoCheckpoint(path, every)``
    when ``path`` is given (its barriers discarded first): seconds, the
    aggregation and the checkpoint."""
    from gelly_streaming_tpu_torch.aggregate.autockpt import AutoCheckpoint
    from gelly_streaming_tpu_torch.library import ConnectedComponents

    agg = ConnectedComponents()
    ac = None
    t0 = time.perf_counter()
    if path is None:
        it = make_stream(None).aggregate(agg)
    else:
        ac = AutoCheckpoint(path, every=every)
        ac.discard()
        t0 = time.perf_counter()
        it = ac.run(make_stream, agg)
    n = sum(1 for _ in it)
    agg.sync()
    return time.perf_counter() - t0, n, agg, ac


def _median_ms(fn, torch, reps):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_durability(torch, oracle):
    import pickle
    import tempfile

    from gelly_streaming_tpu_torch import CountWindow, datasets, obs
    from gelly_streaming_tpu_torch.aggregate.autockpt import AutoCheckpoint
    from gelly_streaming_tpu_torch.example.common import supervised_emissions
    from gelly_streaming_tpu_torch.library import ConnectedComponents, DegreeDistribution
    from gelly_streaming_tpu_torch.obs import trace
    from gelly_streaming_tpu_torch.ops import sage_kernels as sk
    from gelly_streaming_tpu_torch.resilience import FaultPlan, faults, integrity
    from gelly_streaming_tpu_torch.resilience.faults import corrupt_file
    from gelly_streaming_tpu_torch.summaries.forest import resolve_flat_host

    path, _ = datasets.ensure_corpus(CC_CORPUS)
    n_edges = datasets.CORPORA[CC_CORPUS].surrogate_edges
    n_win = n_edges // CC_WINDOW
    make_stream = _dur_streams(path)
    want = (oracle["ids"], oracle["labels"])
    ckdir = tempfile.mkdtemp(prefix="smoke_ckpt_", dir=datasets.cache_dir())
    ckpt = os.path.join(ckdir, "cc.ckpt")
    cell = {"every": DUR_EVERY, "keep": DUR_KEEP}

    # (a) kill at pipeline.item 9 under the supervisor, resume from 8; the
    # kernel counts are 0 just before and read just after (the path has
    # no hand-written kernel: its work is host serialization and a D2H)
    sk.LAUNCHES = 0
    reg = obs.set_registry(None)
    sink = _CkptSpans()
    trace.add_sink(sink)
    trace.enable()
    made = []

    def factory():
        made.append(ConnectedComponents())
        return made[-1]

    try:
        with faults.injected(FaultPlan(kill_at_window=DUR_KILL_ITEM, kill_site="pipeline.item")):
            emissions, _ = supervised_emissions(ckpt, DUR_EVERY, make_stream, factory,
                                                keep=DUR_KEEP, resume=False)
            t0 = time.perf_counter()
            seen = 0
            last = None
            for last in emissions:
                seen += 1
            made[-1].sync()
            run_s = time.perf_counter() - t0
    finally:
        trace.disable()
        trace.remove_sink(sink)
    say(f"durability fused_sage_matmul launches in the supervised run: {sk.LAUNCHES}")
    restores = [e.get("attrs", {}).get("windows_done") for e in sink.take("checkpoint.restore")]
    restarts = reg.counter("resilience.restarts", kind="transient").value
    deduped = reg.counter("resilience.deduped_windows").value
    slots = [AutoCheckpoint(p)._read_barrier(p)["windows_done"]
             for p in (ckpt, ckpt + ".1", ckpt + ".2")]
    ok = (seen == n_win and restarts == 1 and deduped == 1 and restores == [0, DUR_RESUME_AT]
          and made[-1]._cc_mode == "forest" and _labels_equal(last.labels(), want)
          and slots == [n_win, n_win - DUR_EVERY, n_win - 2 * DUR_EVERY])
    cell["kill"] = {"windows": seen, "restarts": restarts, "deduped_windows": deduped,
                    "restored_from": restores, "barriers_on_disk": slots,
                    "carry": made[-1]._cc_mode, "seconds": run_s, "equal": bool(ok)}
    say("durability kill/resume " + json.dumps(cell["kill"]))
    if not ok:
        raise AssertionError("the supervised kill/resume of the CC cell failed its checks")
    waits = [e["dur_s"] * 1e3 for e in sink.take("checkpoint.barrier_wait")]
    sers = [e["dur_s"] * 1e3 for e in sink.take("checkpoint.serialize")]
    barriers = [e["dur_s"] * 1e3 for e in sink.take("checkpoint.barrier")]

    # (b) a corrupt head: a fresh checkpoint falls back to the rotated 12
    corrupt_file(ckpt, "flip")
    reg = obs.set_registry(None)
    fresh = AutoCheckpoint(ckpt, every=DUR_EVERY, keep=DUR_KEEP)
    agg = ConnectedComponents()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        done = fresh.windows_done()
        last = None
        for last in fresh.run(make_stream, agg):
            pass
    agg.sync()
    rejected = reg.counter("resilience.ckpt_rejected").value
    ok = (done == n_win - DUR_EVERY and rejected == 1 and last is not None
          and _labels_equal(last.labels(), want))
    cell["corrupt_head"] = {"resumed_from": done, "ckpt_rejected": rejected, "equal": bool(ok)}
    say("durability corrupt head " + json.dumps(cell["corrupt_head"]))
    if not ok:
        raise AssertionError("the corrupt-head fallback failed its checks")
    obs.set_registry(None)

    # (d) the head barrier (written on the card by (b)) restored on the CPU
    sink = _CkptSpans()
    trace.add_sink(sink)
    trace.enable()
    try:
        cpu_agg = ConnectedComponents()
        ac = AutoCheckpoint(ckpt)
        rest = list(ac.run(_dur_streams(path, device="cpu"), cpu_agg))
        em = ac.restored_emission(cpu_agg)
    finally:
        trace.disable()
        trace.remove_sink(sink)
    restore_ms = sink.take("checkpoint.restore")[0]["dur_s"] * 1e3
    on_cpu = cpu_agg._summary["labels"].device.type == "cpu"
    ok = not rest and on_cpu and _labels_equal(em.labels(), want)
    cell["cross_device"] = {"restored_on": "cpu", "windows_left": len(rest),
                            "restore_ms": restore_ms, "equal": bool(ok)}
    say("durability card barrier on the cpu " + json.dumps(cell["cross_device"]))
    if not ok:
        raise AssertionError("the barrier written on the card did not restore on the CPU")

    # (c) the workload kind: DegreeDistribution under AutoCheckpoint(every=2)
    events = _dd_events()
    dd_path = os.path.join(ckdir, "dd.ckpt")
    full = [list(b) for b in DegreeDistribution(CountWindow(DD_WINDOW), device="cuda").run(events)]

    def windows():
        return lambda vd: _EventWindows(events, DD_WINDOW)

    before = []
    run = AutoCheckpoint(dd_path, every=DUR_DD_EVERY).run(
        windows(), _WindowedDD(DegreeDistribution(CountWindow(DD_WINDOW), device="cuda")))
    for b in run:
        before.append(list(b))
        if len(before) == DUR_DD_KILL_AFTER:
            break  # the run dies here: its generator is abandoned
    run.close()
    ac = AutoCheckpoint(dd_path, every=DUR_DD_EVERY)
    done = ac.windows_done()
    dd = DegreeDistribution(CountWindow(DD_WINDOW), device="cuda")
    after = [list(b) for b in ac.run(windows(), _WindowedDD(dd))]
    ok = (done == DUR_DD_KILL_AFTER - DUR_DD_KILL_AFTER % DUR_DD_EVERY
          and before == full[:DUR_DD_KILL_AFTER] and before[:done] + after == full)
    cell["degree_distribution"] = {"events": DD_EVENTS, "windows": len(full), "resumed_from": done,
                                   "replayed": DUR_DD_KILL_AFTER - done, "equal": bool(ok)}
    say("durability degree distribution " + json.dumps(cell["degree_distribution"]))
    if not ok:
        raise AssertionError("the DegreeDistribution resume differs from the uninterrupted run")

    # (e) times: edges/s with barriers every 4 windows and without, in
    # alternating pairs; the parts of a barrier; its bound; the auto cadence
    pairs = []
    for i in range(DUR_PAIRS):
        order = ("none", "every") if i % 2 == 0 else ("every", "none")
        got = {}
        for kind in order:
            sec, n, _, _ = _ckpt_pass(torch, make_stream,
                                      None if kind == "none" else ckpt, DUR_EVERY)
            if n != n_win:
                raise AssertionError(f"a timed pass ran {n} windows")
            got[kind] = n_edges / sec
        pairs.append(got)
    plain = statistics.median(p["none"] for p in pairs)
    with_b = statistics.median(p["every"] for p in pairs)
    cell["edges_per_s"] = {"no_barriers": plain, "every_4": with_b, "pairs": pairs,
                           "ratio": with_b / plain}
    say(f"durability edges/s (median of {DUR_PAIRS} alternating pairs): no barriers "
        f"{plain:.0f}, every {DUR_EVERY} windows {with_b:.0f}, ratio {with_b / plain:.3f}")

    # the parts of one barrier, on the last forest carry: the download, the
    # host resolve, the pickle, the checksum, the write
    _, _, agg, _ = _ckpt_pass(torch, make_stream)
    from gelly_streaming_tpu_torch.summaries.labels import to_numpy

    d2h = _median_ms(lambda: to_numpy(agg._canon), torch, 5)
    canon = to_numpy(agg._canon)
    resolve = _median_ms(lambda: resolve_flat_host(canon), torch, 5)
    state = agg.snapshot_state()
    payload = {"windows_done": n_win, "kind": "aggregation",
               "state": {"summary": state, "vcap": int(agg._vcap)},
               "vdict": {"kind": "identity", "id_bound": CC_ID_BOUND, "observed": CC_ID_BOUND}}
    dumps = _median_ms(lambda: pickle.dumps(payload), torch, 5)
    raw = pickle.dumps(payload)
    crc = _median_ms(lambda: integrity.wrap_checksummed(raw), torch, 5)
    blob = integrity.wrap_checksummed(raw)
    probe = os.path.join(ckdir, "write_probe")

    def write():
        with open(probe, "wb") as f:
            f.write(blob)

    nbytes = os.path.getsize(ckpt)
    write_ms = _median_ms(write, torch, 5)
    # the bound: the barrier's bytes over a plain D2H copy's rate and a
    # plain file write's rate, both measured here
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    d2h_plain = _median_ms(lambda: dev.to("cpu"), torch, 7)
    host = np.zeros(nbytes, np.uint8).tobytes()

    def write_plain():
        with open(probe, "wb") as f:
            f.write(host)

    write_plain_ms = _median_ms(write_plain, torch, 5)
    os.remove(probe)
    bound = d2h_plain + write_plain_ms
    barrier_ms = statistics.median(barriers)
    h2d = _median_ms(lambda: (torch.as_tensor(state["labels"]).to("cuda"),
                              torch.as_tensor(state["touched"]).to("cuda")), torch, 5)
    cell["barrier"] = {
        "bytes": nbytes, "barriers": len(barriers), "barrier_ms": barriers,
        "barrier_wait_ms": waits, "serialize_ms": sers,
        "parts_ms": {"d2h_canon": d2h, "resolve_flat_host": resolve, "pickle": dumps,
                     "crc32_frame": crc, "write": write_ms},
        "restore_ms": restore_ms, "restore_h2d_ms": h2d,
        "bound_ms": bound, "bound_parts_ms": {"d2h_plain": d2h_plain, "write_plain": write_plain_ms},
        "d2h_gb_per_s": nbytes / d2h_plain / 1e6, "write_gb_per_s": nbytes / write_plain_ms / 1e6,
        "bound_share": bound / barrier_ms,
    }
    say("durability barrier " + json.dumps(cell["barrier"]))

    # the cadence every="auto" settles on for this cell
    sec, n, _, ac = _ckpt_pass(torch, make_stream, ckpt, "auto")
    cell["auto"] = {"every": ac.every, "barrier_s": ac.measured_barrier_s,
                    "window_s": ac.measured_window_s, "edges_per_s": n_edges / sec,
                    "target_overhead": ac.target_overhead}
    say("durability every=auto " + json.dumps(cell["auto"]))
    shutil.rmtree(ckdir, ignore_errors=True)
    return cell


# ---------------------------------------------------------------------- #
# Phase 17: superbatch="auto" (the AutoK controller) on the card
# ---------------------------------------------------------------------- #
def _corpus_prefix(n_edges):
    """The first ``n_edges`` corpus edges from its binary cache, as int64
    columns (``bench.py:_corpus_cols``)."""
    from gelly_streaming_tpu_torch import datasets

    path, _ = datasets.ensure_corpus(CC_CORPUS)
    cols, have = [], 0
    for s, d, _v in datasets.iter_binary_chunks(datasets.binary_cache(path), 1 << 22):
        cols.append((s, d))
        have += len(s)
        if have >= n_edges:
            break
    src = np.concatenate([c[0] for c in cols])[:n_edges].astype(np.int64)
    dst = np.concatenate([c[1] for c in cols])[:n_edges].astype(np.int64)
    return src, dst


def _cache_dir():
    from gelly_streaming_tpu_torch import datasets

    os.makedirs(datasets.cache_dir(), exist_ok=True)
    return datasets.cache_dir()


def _ak_stream(src, dst, window, bound):
    from gelly_streaming_tpu_torch import SimpleEdgeStream
    from gelly_streaming_tpu_torch.datasets import IdentityDict

    return SimpleEdgeStream((src, dst), window=window, vertex_dict=IdentityDict(bound),
                            device="cuda")


def _ak_cc_pass(src, dst, superbatch, window=AK_WINDOW, bound=CC_ID_BOUND, plane=None):
    """One CC pass as ``bench_autotune_pair`` runs it, ``sync()`` timed:
    seconds, the aggregation, the last emission, windows, host reads."""
    from gelly_streaming_tpu_torch import CountWindow
    from gelly_streaming_tpu_torch.library import ConnectedComponents
    from gelly_streaming_tpu_torch.summaries import labels

    agg = ConnectedComponents(superbatch=superbatch)
    agg.control = plane
    labels.HOST_READS = 0
    policy = window if not isinstance(window, int) else CountWindow(window)
    t0 = time.perf_counter()
    n = 0
    last = None
    for last in agg.run(_ak_stream(src, dst, policy, bound)):
        n += 1
    agg.sync()
    return time.perf_counter() - t0, agg, last, n, labels.HOST_READS


def _k_path(ak):
    return [[o, n, sig] for o, n, sig in ak.history]


def phase_autok(torch):
    import tempfile
    import zlib

    from gelly_streaming_tpu_torch import CountWindow, ScheduledCountWindow, datasets
    from gelly_streaming_tpu_torch.aggregate.autockpt import AutoCheckpoint
    from gelly_streaming_tpu_torch.control import AutoK, ControlPlane, PrefetchTuner
    from gelly_streaming_tpu_torch.library import ConnectedComponents, IncrementalPageRank
    from gelly_streaming_tpu_torch.ops import sage_kernels as sk
    from gelly_streaming_tpu_torch.resilience import FaultPlan, SimulatedCrash, faults

    cell = {}
    sk.LAUNCHES = 0

    # (a) the cliff cell: hand K against auto, alternating in one process
    src, dst = _corpus_prefix(AK_EDGES)
    _ak_cc_pass(src, dst, AK_HAND_K)
    _ak_cc_pass(src, dst, "auto")  # warm both shapes
    hand, auto, last_auto = [], [], None
    for _ in range(AK_PAIRS):
        sec, _, _, n_h, _ = _ak_cc_pass(src, dst, AK_HAND_K)
        hand.append(AK_EDGES / sec)
        sec, last_auto, last, n_a, _ = _ak_cc_pass(src, dst, "auto")
        auto.append(AK_EDGES / sec)
    ak = last_auto.control.autok
    hand_med, auto_med = statistics.median(hand), statistics.median(auto)
    # host reads a window at the controller's final K (a pinned pass)
    sec_f, _, _, n_f, reads = _ak_cc_pass(src, dst, int(ak.k))
    cliff = {
        "window": AK_WINDOW, "edges": AK_EDGES, "windows": n_a, "carry": last_auto._cc_mode,
        "hand": {"superbatch": AK_HAND_K, "edges_per_s": hand_med, "edges_per_s_all": hand},
        "auto": {"edges_per_s": auto_med, "edges_per_s_all": auto, "k_final": int(ak.k),
                 "retunes": len(ak.history), "k_path": _k_path(ak)},
        "ratio_auto_vs_hand": auto_med / hand_med,
        "at_k_final": {"superbatch": int(ak.k), "edges_per_s": AK_EDGES / sec_f,
                       "host_reads_per_window": reads / n_f},
    }
    say("autok cliff " + json.dumps(cliff))
    want = oracle_labels(src, dst, CC_ID_BOUND)
    seen = np.zeros(CC_ID_BOUND, bool)
    seen[src] = True
    seen[dst] = True
    ids, got = last.labels()
    want_ids = np.nonzero(seen)[0]
    ok = (n_h == n_a == AK_EDGES // AK_WINDOW and last_auto._cc_mode == "forest"
          and np.array_equal(ids, want_ids) and np.array_equal(got, want[want_ids]))
    say(f"autok cliff last window vs scipy ({len(ids)} vertices): {'exact' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the auto-K cliff cell disagrees with scipy or ran another carry")
    cliff["scipy_exact"] = True
    cell["cliff"] = cliff
    del want, seen

    # (b) the shift cell: ScheduledCountWindow 1024 -> 8192 at window 512,
    # ids folded into 2^16, against the pinned K = 1 run, emission by emission
    src, dst = _corpus_prefix(AK_SHIFT_EDGES)
    src %= AK_SHIFT_FOLD
    dst %= AK_SHIFT_FOLD

    def digests(plane):
        agg = ConnectedComponents(superbatch="auto")
        agg.control = plane
        out = []
        t0 = time.perf_counter()
        for c in agg.run(_ak_stream(src, dst, ScheduledCountWindow(AK_SHIFT_SCHEDULE),
                                    AK_SHIFT_FOLD)):
            ids, lab = c.labels()
            out.append((zlib.crc32(ids.tobytes()), zlib.crc32(lab.tobytes())))
        agg.sync()
        return agg, out, time.perf_counter() - t0

    _, base, _ = digests(ControlPlane(autok=AutoK(k0=1, k_max=1)))
    agg, got, sec = digests(ControlPlane(autok=AutoK(k_max=AK_SHIFT_KMAX, decide_groups=2),
                                         prefetch=PrefetchTuner()))
    ak = agg.control.autok
    mismatches = sum(a != b for a, b in zip(base, got)) + abs(len(base) - len(got))
    shift = {"schedule": [list(x) for x in AK_SHIFT_SCHEDULE], "windows": len(got),
             "edges": AK_SHIFT_EDGES, "id_fold": AK_SHIFT_FOLD, "k_max": AK_SHIFT_KMAX,
             "edges_per_s": AK_SHIFT_EDGES / sec, "oracle_mismatches": int(mismatches),
             "k_final": int(ak.k), "k_path": _k_path(ak),
             "prefetch_depth_path": [[o, n, sig] for o, n, sig in agg.control.prefetch.history],
             "shift_retuned": any(sig == "window-shift" for _o, _n, sig in ak.history)}
    say("autok shift " + json.dumps(shift))
    if mismatches or not shift["shift_retuned"]:
        raise AssertionError("the shift cell differs from pinned K = 1 or never re-tuned on the "
                             "window-size shift")
    cell["shift"] = shift

    # (c1) PageRank, the negative control of bench.py:908: the reference
    # holds K = 1 there on its CPU record; here the controller's end K is
    # measured and printed beside the per-window loop and the adaptive
    # path pinned at K = 1, and the ranks must equal the pinned run's
    psrc, pdst = _corpus_prefix(AK_PR_EDGES)
    psrc %= AK_PR_FOLD
    pdst %= AK_PR_FOLD

    def pr_pass(mode):
        pr = IncrementalPageRank(superbatch=1 if mode == "pinned" else "auto")
        if mode == "dynamic_k1":
            pr.control = ControlPlane(autok=AutoK(k0=1, k_max=1))
        t0 = time.perf_counter()
        for _ in pr.run(_ak_stream(psrc, pdst, CountWindow(AK_WINDOW), AK_PR_FOLD)):
            pass
        pr.sync()
        return AK_PR_EDGES / (time.perf_counter() - t0), pr

    modes = ("pinned", "auto", "dynamic_k1")
    for mode in modes:
        pr_pass(mode)  # warm each shape
    eps = {m: [] for m in modes}
    runs = {}
    for i in range(AK_PAIRS):
        for mode in (modes if i % 2 == 0 else modes[::-1]):
            e, runs[mode] = pr_pass(mode)
            eps[mode].append(e)
    ak = runs["auto"].control.autok
    pr_r, au_r = runs["pinned"].ranks(), runs["auto"].ranks()
    rank_err = max(abs(pr_r[v] - au_r[v]) for v in pr_r)
    med = {m: statistics.median(v) for m, v in eps.items()}
    hold = {"window": AK_WINDOW, "edges": AK_PR_EDGES, "id_fold": AK_PR_FOLD,
            "pinned_edges_per_s": med["pinned"], "pinned_all": eps["pinned"],
            "auto_edges_per_s": med["auto"], "auto_all": eps["auto"],
            "dynamic_k1_edges_per_s": med["dynamic_k1"], "dynamic_k1_all": eps["dynamic_k1"],
            "ratio_auto_vs_pinned": med["auto"] / med["pinned"],
            "ratio_dynamic_k1_vs_pinned": med["dynamic_k1"] / med["pinned"],
            "k_final": int(ak.k), "held_k1": int(ak.k) == 1, "k_path": _k_path(ak),
            "max_rank_err": rank_err}
    say("autok pagerank hold " + json.dumps(hold))
    if set(pr_r) != set(au_r) or rank_err > 1e-6:
        raise AssertionError("auto-K PageRank's ranks differ from the pinned run's")
    cell["pagerank_hold"] = hold

    # (c2) a kill at pipeline.item under superbatch="auto" through
    # AutoCheckpoint, resumed to the uninterrupted run's labels
    want = _ak_cc_pass(src, dst, 1, window=AK_WINDOW, bound=AK_SHIFT_FOLD)[2].labels()
    ckdir = tempfile.mkdtemp(prefix="smoke_autok_", dir=_cache_dir())
    path = os.path.join(ckdir, "auto.ckpt")

    def make_stream(vdict):
        from gelly_streaming_tpu_torch import SimpleEdgeStream

        return SimpleEdgeStream((src, dst), window=CountWindow(AK_WINDOW),
                                vertex_dict=vdict if vdict is not None
                                else datasets.IdentityDict(AK_SHIFT_FOLD), device="cuda")

    first = ConnectedComponents(superbatch="auto")
    crashed, seen_w = False, 0
    with faults.injected(FaultPlan(kill_at_window=AK_KILL_ITEM, kill_site="pipeline.item")):
        try:
            for _ in AutoCheckpoint(path, every=AK_KILL_EVERY).run(make_stream, first):
                seen_w += 1
        except SimulatedCrash:
            crashed = True
    done = AutoCheckpoint(path).windows_done()
    second = ConnectedComponents(superbatch="auto")
    tail = 0
    for last in AutoCheckpoint(path, every=AK_KILL_EVERY).run(make_stream, second):
        tail += 1
    second.sync()
    kill = {"killed_at_item": AK_KILL_ITEM, "crashed": crashed, "windows_before_kill": seen_w,
            "resumed_from": done, "windows_after": tail,
            "k_path_before": _k_path(first.control.autok),
            "k_path_after": _k_path(second.control.autok)}
    ok = (crashed and 0 < done <= seen_w and done + tail == len(src) // AK_WINDOW
          and _labels_equal(last.labels(), want))
    kill["equal"] = bool(ok)
    say("autok kill/resume " + json.dumps(kill))
    shutil.rmtree(ckdir, ignore_errors=True)
    if not ok:
        raise AssertionError("the auto-K kill and resume did not reach the uninterrupted labels")
    cell["kill"] = kill
    say(f"autok fused_sage_matmul launches in phase 17: {sk.LAUNCHES} (the path has no "
        "hand-written kernel; the forest carry's steps are PyTorch operations)")
    cell["fused_sage_matmul_launches"] = sk.LAUNCHES
    return cell


# ---------------------------------------------------------------------- #
# Phase 18: event-time sliding windows with retraction
# ---------------------------------------------------------------------- #
def _drifting_ts_stream(panes, per_pane, vspan, seed=7, wrap=12):
    """``bench.py:_drifting_ts_stream``: pane ``p``'s edges live on
    vertices ``[b, b + vspan)`` with ``b = (p % wrap) * vspan / 2``, so
    consecutive panes share half their vertex range and retired keys recur
    once they have aged out of every live window."""
    rng = np.random.default_rng(seed)
    srcs, dsts, tss = [], [], []
    for p in range(panes):
        base = (p % wrap) * (vspan // 2)
        srcs.append(base + rng.integers(0, vspan, per_pane))
        dsts.append(base + rng.integers(0, vspan, per_pane))
        tss.append(np.full(per_pane, p, np.int64))
    return (np.concatenate(srcs).astype(np.int64), np.concatenate(dsts).astype(np.int64),
            np.concatenate(tss))


def _et_push_all(agg, src, dst, ts, chunk=ET_CHUNK):
    out = []
    for a in range(0, len(src), chunk):
        out.extend(agg.push(src[a:a + chunk], dst[a:a + chunk], ts[a:a + chunk]))
    out.extend(agg.finish())
    return out


def _skewed_panes(n=ET_SKEW_RECORDS, vmax=ET_SKEW_VMAX, skew=ET_SKEW):
    """The skewed two-shard stream of ``tests/test_eventtime.py:513``: one
    shard's timestamps jitter within +/- ``skew``; the lateness allowance
    covers it. Returns the closed panes' columns in close order and the
    records dropped."""
    from gelly_streaming_tpu_torch.eventtime import (
        EventTimeSlidingWindow,
        PaneAssembler,
        WatermarkTracker,
    )
    from gelly_streaming_tpu_torch.resilience import FaultPlan

    rng = np.random.default_rng(19)
    src = rng.integers(0, vmax, n).astype(np.int64)
    dst = rng.integers(0, vmax, n).astype(np.int64)
    ts = np.arange(n, dtype=np.int64) // 8
    plan = FaultPlan(seed=19, skew_records=tuple(range(1, n, 2)), skew_ts_s=skew)
    recs = list(plan.perturb_records(
        iter([(int(s), int(d), 0.0, int(t)) for s, d, t in zip(src, dst, ts)])))
    tr = WatermarkTracker(2)
    asm = PaneAssembler(EventTimeSlidingWindow(4, 4), allowed_lateness=2 * skew + 2)
    panes, dropped, wm = [], 0, tr.current()
    for lo in range(0, n, 512):
        chunk = recs[lo:lo + 512]
        for shard in (0, 1):
            mine = [r for i, r in enumerate(chunk) if (lo + i) % 2 == shard]
            dropped += asm.add(np.array([r[0] for r in mine], np.int64),
                               np.array([r[1] for r in mine], np.int64),
                               np.array([r[3] for r in mine], np.int64), wm)
            tr.observe(shard, np.array([r[3] for r in mine], np.int64))
        wm = tr.current()
        panes.extend(asm.advance(wm))
    panes.extend(asm.flush())
    cols = [p.cols() for p in panes if len(p)]
    return (np.concatenate([c[0] for c in cols]), np.concatenate([c[1] for c in cols]),
            dropped, len(cols))


def phase_eventtime(torch):
    import tempfile

    from gelly_streaming_tpu_torch import CountWindow
    from gelly_streaming_tpu_torch.eventtime import (
        SlidingGraphAggregator,
        oracle_bipartite,
        oracle_degrees,
        oracle_labels,
    )
    from gelly_streaming_tpu_torch.library import ConnectedComponents
    from gelly_streaming_tpu_torch.ops import sage_kernels as sk
    from gelly_streaming_tpu_torch.resilience import FaultPlan, SimulatedCrash, faults

    sk.LAUNCHES = 0
    cell = {}
    src, dst, ts = _drifting_ts_stream(ET_PANES, ET_PER_PANE, ET_VSPAN)
    n_edges = len(src)

    # the sliding cell: edges/s of the aggregator (watermarks, panes,
    # retraction, all three summaries), one warm pass and the median of 3
    def one_pass(verify=False):
        agg = SlidingGraphAggregator(ET_WINDOW_PANES, 1, verify=verify)
        t0 = time.perf_counter()
        res = _et_push_all(agg, src, dst, ts)
        return time.perf_counter() - t0, res

    one_pass()
    secs = [one_pass()[0] for _ in range(ET_STEADY_PASSES)]
    sec_v, res_v = one_pass(verify=True)  # raises on any mismatch
    sliding = {"edges": n_edges, "panes": ET_PANES, "per_pane": ET_PER_PANE,
               "vspan": ET_VSPAN, "window_panes": ET_WINDOW_PANES,
               "edges_per_s": n_edges / statistics.median(secs),
               "edges_per_s_all": [n_edges / t for t in secs],
               "windows": len(res_v), "verify_pass_s": sec_v, "verify_mismatches": 0}
    say("eventtime sliding " + json.dumps(sliding))

    # the retract cell: every expiry's incremental cycle against a
    # from-scratch rebuild of the three summaries on the survivors
    agg = SlidingGraphAggregator(ET_WINDOW_PANES, 1)
    t_inc = t_rebuild = 0.0
    refolded, mismatches, cycles = [], 0, 0
    for a in range(0, n_edges, ET_CHUNK):
        t0 = time.perf_counter()
        results = agg.push(src[a:a + ET_CHUNK], dst[a:a + ET_CHUNK], ts[a:a + ET_CHUNK])
        t_inc += time.perf_counter() - t0
        for res in results:
            if res.repair is None:
                continue  # the window is still filling
            cycles += 1
            refolded.append(res.repair["refolded"])
            m = (ts >= res.start) & (ts < res.end)
            s, d = src[m], dst[m]
            vcap = len(res.labels)
            t0 = time.perf_counter()
            want_lab = oracle_labels(vcap, s, d)
            want_deg = oracle_degrees(vcap, s, d)
            want_bip = oracle_bipartite(vcap, s, d)
            t_rebuild += time.perf_counter() - t0
            if (not np.array_equal(res.labels, want_lab)
                    or not np.array_equal(res.degrees, want_deg) or res.bipartite != want_bip):
                mismatches += 1
    retract = {"expiry_cycles": cycles, "incremental_s": t_inc, "rebuild_s": t_rebuild,
               "ratio_rebuild_vs_retract": t_rebuild / t_inc,
               "refolded_median": float(np.median(refolded)),
               "surviving_per_cycle": ET_PER_PANE * ET_WINDOW_PANES, "mismatches": mismatches}
    say("eventtime retract " + json.dumps(retract))
    # every pane past the first window expires one; the last window
    # closes at finish(), outside the timed pushes (bench.py counts 87)
    if mismatches or cycles != ET_PANES - ET_WINDOW_PANES - 1:
        raise AssertionError(f"{mismatches} windows differ from the rebuild over {cycles} cycles")
    cell["sliding"] = sliding
    cell["retract"] = retract

    # the kill at eventtime.retract before the commit recovers to the
    # uninterrupted run's answers (which verify=True held to the oracles)
    k_src, k_dst, k_ts = (c[:ET_KILL_PANES * ET_PER_PANE] for c in (src, dst, ts))
    base = {r.index: r for r in _et_push_all(
        SlidingGraphAggregator(ET_WINDOW_PANES, 1, verify=True), k_src, k_dst, k_ts)}
    cdir = tempfile.mkdtemp(prefix="smoke_et_", dir=_cache_dir())
    crashed = False
    with faults.injected(FaultPlan(kill_at_window=ET_KILL_AT, kill_site="eventtime.retract",
                                   kill_exit_code=None)):
        try:
            _et_push_all(SlidingGraphAggregator(ET_WINDOW_PANES, 1, commit_dir=cdir),
                         k_src, k_dst, k_ts)
        except SimulatedCrash:
            crashed = True
    back = SlidingGraphAggregator(ET_WINDOW_PANES, 1, commit_dir=cdir, verify=True)
    t0 = time.perf_counter()
    restored = back.restore()
    restore_ms = (time.perf_counter() - t0) * 1e3
    done = back._done_panes
    got = {r.index: r for r in _et_push_all(back, k_src, k_dst, k_ts)}
    ok = (crashed and restored and done == ET_KILL_AT
          and sorted(got) == [i for i in sorted(base) if i >= done]
          and all(np.array_equal(got[i].labels, base[i].labels)
                  and np.array_equal(got[i].degrees, base[i].degrees)
                  and got[i].bipartite == base[i].bipartite and got[i].top == base[i].top
                  for i in got))
    shutil.rmtree(cdir, ignore_errors=True)
    cell["kill"] = {"panes": ET_KILL_PANES, "killed_at_pane": ET_KILL_AT, "crashed": crashed,
                    "resumed_from": done, "restore_ms": restore_ms,
                    "windows_after": len(got), "equal": bool(ok)}
    say("eventtime kill/restore " + json.dumps(cell["kill"]))
    if not ok:
        raise AssertionError("the kill at eventtime.retract did not recover the oracle answers")

    # the skewed two-shard stream: no record dropped; its closed panes
    # under superbatch="auto" on the card equal superbatch=1 on the card
    t0 = time.perf_counter()
    p_src, p_dst, dropped, n_panes = _skewed_panes()
    pane_s = time.perf_counter() - t0

    def pane_pass(superbatch):
        agg = ConnectedComponents(superbatch=superbatch)
        t1 = time.perf_counter()
        ems = list(agg.run(_ak_stream(p_src, p_dst, CountWindow(ET_SKEW_WINDOW),
                                      ET_SKEW_VMAX)))
        agg.sync()
        return agg, ems, time.perf_counter() - t1

    _, ems1, sec1 = pane_pass(1)
    agg_a, ems_a, sec_a = pane_pass("auto")
    same = len(ems1) == len(ems_a) and all(
        _labels_equal(a.labels(), b.labels()) for a, b in zip(ems1, ems_a))
    skew = {"records": ET_SKEW_RECORDS, "dropped": dropped, "panes": n_panes,
            "conserved": int(len(p_src)) == ET_SKEW_RECORDS, "assembly_s": pane_s,
            "windows": len(ems_a), "carry": agg_a._cc_mode,
            "k_path": _k_path(agg_a.control.autok), "k1_s": sec1, "auto_s": sec_a,
            "auto_equal_to_k1": bool(same)}
    say("eventtime skewed panes on the card " + json.dumps(skew))
    if dropped or not skew["conserved"] or not same or agg_a._cc_mode != "forest":
        raise AssertionError("the skewed panes dropped records or auto-K differs from K = 1")
    cell["skew"] = skew

    # the busy share: a profiled pass of the path that reaches the card
    # (pane assembly on the host, then the panes' CC under auto-K)
    def card_pass():
        ps, pd, _, _ = _skewed_panes()
        agg = ConnectedComponents(superbatch="auto")
        for _ in agg.run(_ak_stream(ps, pd, CountWindow(ET_SKEW_WINDOW), ET_SKEW_VMAX)):
            pass
        agg.sync()

    t0 = time.perf_counter()
    card_pass()
    wall = time.perf_counter() - t0
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        card_pass()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cell["busy_share"] = profile_pass(torch, lambda: None, wall, prof=prof)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        agg = SlidingGraphAggregator(ET_WINDOW_PANES, 1)
        _et_push_all(agg, src[:ET_KILL_PANES * ET_PER_PANE], dst[:ET_KILL_PANES * ET_PER_PANE],
                     ts[:ET_KILL_PANES * ET_PER_PANE])
        wall = time.perf_counter() - t0
    cell["sliding_busy_share"] = profile_pass(torch, lambda: None, wall, prof=prof)
    say(f"eventtime fused_sage_matmul launches in phase 18: {sk.LAUNCHES} (no hand-written "
        "kernel: retraction is host numpy, the panes fold through the forest carry's PyTorch "
        "operations)")
    cell["fused_sage_matmul_launches"] = sk.LAUNCHES
    return cell



# ---------------------------------------------------------------------- #
# Phase 19: sharded ingest, the fabric and multi-process recovery
# ---------------------------------------------------------------------- #
def _start_peer(conns, fmt, accepts):
    """The port's serve-from-memory peer (``python -m
    gelly_streaming_tpu_torch.core.ingest --serve``) as a subprocess that
    sees no card (it must never touch one)."""
    return subprocess.Popen(
        [sys.executable, "-m", "gelly_streaming_tpu_torch.core.ingest", "--serve",
         "--shards", str(conns), "--edges", str(IG_EDGES), "--scale", str(IG_SCALE),
         "--seed", str(IG_SEED), "--format", fmt, "--frame-edges", str(IG_FRAME_EDGES),
         "--accepts", str(accepts)],
        stdout=subprocess.PIPE, cwd=os.path.dirname(os.path.abspath(__file__)),
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
    )


def _ingest_stream(conns, fmt, ports, device="cuda"):
    from gelly_streaming_tpu_torch import CountWindow, SimpleEdgeStream
    from gelly_streaming_tpu_torch.core.ingest import ShardedEdgeSource
    from gelly_streaming_tpu_torch.core.sources import SocketEdgeSource

    if conns == 1 and fmt == "text":
        # the baseline: the one socket reader every edge used to enter by
        return SimpleEdgeStream(SocketEdgeSource("127.0.0.1", ports[0], tick_s=0.05),
                                window=CountWindow(IG_WINDOW), device=device)
    return ShardedEdgeSource([("127.0.0.1", p) for p in ports], window=IG_WINDOW, fmt=fmt,
                             queue_windows=IG_QUEUE_WINDOWS).stream(device=device)


def _counter_sum(reg, name):
    return float(sum(inst.value for _, inst in reg.find(name)))


def phase_ingest(torch):
    import tempfile
    import threading

    from gelly_streaming_tpu_torch import obs
    from gelly_streaming_tpu_torch.core.ingest import (
        ShardedEdgeSource,
        encode_shard_frames,
        partition_edges,
        serve_blobs,
    )
    from gelly_streaming_tpu_torch.eventtime import (
        SlidingGraphAggregator,
        drive_sliding,
        oracle_bipartite,
        oracle_degrees,
    )
    from gelly_streaming_tpu_torch.eventtime import oracle_labels as et_oracle_labels
    from gelly_streaming_tpu_torch.library import ConnectedComponents
    from gelly_streaming_tpu_torch.obs.registry import nearest_rank
    from gelly_streaming_tpu_torch.ops import sage_kernels as sk
    from gelly_streaming_tpu_torch.summaries import labels

    cell = {}
    # every peer starts now and pre-encodes in parallel; each serves its
    # connections in turn (a re-accept replays the whole stream)
    extra = {(4, "binary"): 1 + STEADY_PASSES + 1, (1, "text"): 1 + STEADY_PASSES}
    t0 = time.perf_counter()
    peers = {key: _start_peer(key[0], key[1], IG_REPS + extra.get(key, 0)) for key in IG_CELLS}
    try:
        ready = {key: json.loads(p.stdout.readline()) for key, p in peers.items()}
        say(f"ingest peers ready in {time.perf_counter() - t0:.1f} s (no card visible to them): "
            + json.dumps({f"c{k[0]}_{k[1]}": r["per_shard"] for k, r in ready.items()}))
        if any(r["edges"] != IG_EDGES for r in ready.values()):
            raise AssertionError("a peer serves another edge count")

        # (a) the ingest cells: superbatch groups assembled and encoded
        def group_edges(g):
            if g.cols is not None:
                return sum(len(c[0]) for c in g.cols)
            return sum(len(b._host_cache[0]) for b in g._blocks)

        cells = {}
        for conns, fmt in IG_CELLS:
            runs = []
            for _ in range(IG_REPS):
                reg = obs.set_registry(None)
                stream = _ingest_stream(conns, fmt, ready[(conns, fmt)]["ports"])
                t1 = time.perf_counter()
                consumed = sum(group_edges(g) for g in stream.superbatches(IG_SUPERBATCH))
                dt = time.perf_counter() - t1
                runs.append({"seconds": dt, "eps": IG_EDGES / dt, "consumed": consumed,
                             "backpressure_s": _counter_sum(reg, "source.backpressure_s"),
                             "malformed_frames": _counter_sum(reg, "source.malformed_frames"),
                             "malformed_lines": _counter_sum(reg, "source.malformed_lines"),
                             "reconnects": _counter_sum(reg, "source.reconnects")})
            key = f"c{conns}_{fmt}"
            mid = sorted(runs, key=lambda r: r["eps"])[len(runs) // 2]
            cells[key] = {"connections": conns, "format": fmt, "edges_per_s": mid["eps"],
                          "seconds": mid["seconds"], "edges_per_s_all": [r["eps"] for r in runs],
                          "consumed": [r["consumed"] for r in runs],
                          "backpressure_s": [r["backpressure_s"] for r in runs],
                          "malformed_frames": [r["malformed_frames"] for r in runs],
                          "malformed_lines": [r["malformed_lines"] for r in runs],
                          "reconnects": [r["reconnects"] for r in runs]}
            say(f"ingest {key} " + json.dumps(cells[key]))
            if (any(c != IG_EDGES for c in cells[key]["consumed"])
                    or any(cells[key]["malformed_frames"]) or any(cells[key]["malformed_lines"])):
                raise AssertionError(f"ingest {key} lost edges or saw malformed input")
        cell["cells"] = cells
        cell["ratio_c4_binary_vs_c1_text"] = (cells["c4_binary"]["edges_per_s"]
                                              / cells["c1_text"]["edges_per_s"])
        say(f"ingest c4_binary / c1_text: {cell['ratio_c4_binary_vs_c1_text']:.3f} "
            f"(host cores {os.cpu_count()})")

        # (b) the slice's main path: the same streams into streaming CC on
        # the card, sync() inside the timed region
        src, dst = rmat_columns(IG_EDGES, IG_SCALE, chunk=IG_EDGES, seed=IG_SEED)
        seen = np.unique(np.concatenate([src, dst]))
        want = oracle_labels(src, dst, 1 << IG_SCALE)

        def cc_pass(key):
            stream = _ingest_stream(key[0], key[1], ready[key]["ports"])
            agg = ConnectedComponents(superbatch=IG_SUPERBATCH)
            labels.HOST_READS = 0
            lat, last = [], None
            t1 = last_t = time.perf_counter()
            for last in stream.aggregate(agg):
                now = time.perf_counter()
                lat.append(now - last_t)
                last_t = now
            agg.sync()
            dt = time.perf_counter() - t1
            per_group = np.add.reduceat(np.asarray(lat), np.arange(0, len(lat), IG_SUPERBATCH))
            return {"seconds": dt, "windows": len(lat),
                    "p50_ms": float(np.percentile(np.asarray(lat) * 1e3, 50)),
                    "group_p50_ms": float(np.percentile(per_group * 1e3, 50)),
                    "host_reads_per_window": labels.HOST_READS / len(lat),
                    "carry": agg._cc_mode}, last, stream

        sk.LAUNCHES = 0
        main = {}
        for key in IG_CC_CELLS:
            cc_pass(key)  # warm
            runs = [cc_pass(key) for _ in range(STEADY_PASSES)]
            res, last, stream = sorted(runs, key=lambda r: r[0]["seconds"])[len(runs) // 2]
            ok, n_seen, n_comp = _raw_partition_ok(last, stream.vertex_dict, want, seen)
            name = f"c{key[0]}_{key[1]}"
            main[name] = dict(res, edges_per_s=IG_EDGES / res["seconds"],
                              edges_per_s_all=[IG_EDGES / r[0]["seconds"] for r in runs],
                              vertices=n_seen, components=n_comp, equal_to_scipy=bool(ok))
            say(f"ingest cc {name} " + json.dumps(main[name]))
            if not ok or res["carry"] != "forest":
                raise AssertionError(f"sharded CC over {name} differs from scipy or did not "
                                     f"pick the forest carry ({res['carry']})")
        cell["cc"] = main
        say(f"ingest fused_sage_matmul launches in phase 19's CC path: {sk.LAUNCHES} (the path "
            "has no hand-written kernel; the forest carry's steps are PyTorch operations)")
        cell["fused_sage_matmul_launches"] = sk.LAUNCHES

        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            cc_pass(IG_CC_CELLS[0])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
        cell["cc_busy_share"] = profile_pass(torch, lambda: None, wall, prof=prof)
        for key, p in peers.items():
            if p.wait(timeout=60) != 0:
                raise AssertionError(f"ingest peer c{key[0]}_{key[1]} exited {p.returncode}")
    finally:
        for p in peers.values():
            if p.poll() is None:
                p.kill()
            p.wait()
            p.stdout.close()

    # (c) event time from sharded sockets: phase 18's drifting stream,
    # partitioned with ts, served as GSEW v2 frames
    e_src, e_dst, e_ts = _drifting_ts_stream(ET_PANES, ET_PER_PANE, ET_VSPAN)
    blobs = [encode_shard_frames(s, d, ts=t, frame_edges=IG_FRAME_EDGES)
             for s, d, _v, t in partition_edges(e_src, e_dst, None, IG_ET_SHARDS, ts=e_ts)]
    reg = obs.set_registry(None)
    ports, threads, stop = serve_blobs(blobs)
    source = ShardedEdgeSource([("127.0.0.1", p) for p in ports], window=ET_PER_PANE,
                               timestamps=True)
    agg = SlidingGraphAggregator(ET_WINDOW_PANES, 1, nshards=IG_ET_SHARDS, verify=True)
    t1 = time.perf_counter()
    results = drive_sliding(source.windows_ts(), agg)  # verify=True raises on a mismatch
    dt = time.perf_counter() - t1
    stop.set()
    for t in threads:
        t.join(10)
    final = results[-1]
    m = (e_ts >= final.start) & (e_ts < final.end)
    final_ok = (np.array_equal(final.labels, et_oracle_labels(len(final.labels), e_src[m], e_dst[m]))
                and np.array_equal(final.degrees, oracle_degrees(len(final.degrees), e_src[m],
                                                                 e_dst[m]))
                and final.bipartite == oracle_bipartite(len(final.degrees), e_src[m], e_dst[m]))
    et = {"edges": int(len(e_src)), "shards": IG_ET_SHARDS, "seconds": dt,
          "edges_per_s": len(e_src) / dt, "windows": len(results),
          "pane_closes": _counter_sum(reg, "eventtime.pane_close"),
          "late_dropped": _counter_sum(reg, "eventtime.late_dropped"),
          "verify_mismatches": 0, "final_equal_to_oracles": bool(final_ok)}
    say("ingest eventtime over sharded sockets " + json.dumps(et))
    if not final_ok or et["late_dropped"] or len(results) != ET_PANES:  # one per pane close
        raise AssertionError("event time over sharded sockets differs from the oracles")
    cell["eventtime"] = et

    # (d) real process kills on the card: the 2-process coordinated sweep
    from gelly_streaming_tpu_torch.resilience import chaos

    sweeps = {}
    for transport, windows in (("shared_dir", IG_MP_WINDOWS), ("socket", IG_MP_SOCKET_WINDOWS)):
        work = tempfile.mkdtemp(prefix=f"smoke_mp_{transport}_", dir=_cache_dir())
        obs_log = os.path.join(work, "obs.jsonl")
        t1 = time.perf_counter()
        doc = chaos.run_mp_sweep(
            processes=2, windows=windows, window_edges=128, superbatch=2, every=2,
            corrupt=transport == "shared_dir", failover=False, rpc=False, transport=transport,
            workdir=work, obs_log=obs_log, log=lambda s: None, device=IG_MP_DEVICE)
        wall = time.perf_counter() - t1
        merged = chaos._read_jsonl(obs_log)
        corrupt = [p for p in doc["points"] if p.get("corrupted_epoch") is not None]
        rejected = [e for e in merged if e.get("name") == "resilience.ckpt_rejected"
                    and corrupt and e.get("point") == f"kill_{corrupt[0]['kill_after']:03d}"]
        sweeps[transport] = {
            "ok": doc["ok"], "windows": windows, "kill_points": doc["kill_points"],
            "wall_s": wall, "oracle_s": doc["oracle_s"],
            "cluster_restarts": doc["cluster_restarts_total"],
            "epoch_agreed_points": sum(1 for p in doc["points"] if p.get("epoch_agreed")),
            "resumed_epochs": [p.get("resumed_epochs") for p in doc["points"]],
            "kill_to_first_emission_s": [p.get("kill_to_first_emission_s")
                                         for p in doc["points"]],
            "kill_to_first_emission_p50_s": doc["kill_to_first_emission_s"]["p50"],
            "recovery_s": doc["recovery_s"], "corrupted_epoch": (
                corrupt[0]["corrupted_epoch"] if corrupt else None),
            "rejections_in_merged_log": len(rejected), "merged_events": len(merged),
            "flight_dumps": doc["flight_dumps_total"], "device": doc["config"]["device"]}
        say(f"ingest kill sweep [{transport}] " + json.dumps(sweeps[transport]))
        bad = [p for p in doc["points"] if not p["ok"]]
        if not doc["ok"] or bad:
            raise AssertionError(f"kill sweep [{transport}] failed: {bad}")
        if transport == "shared_dir" and (not corrupt or not rejected):
            raise AssertionError("the corrupt epoch was not skipped with its rejection logged")
        shutil.rmtree(work, ignore_errors=True)
    cell["kill_sweep"] = sweeps

    # (e) fabric latencies, both locally runnable backends
    from gelly_streaming_tpu_torch.fabric import (
        ExchangeDaemon,
        SharedDirTransport,
        SocketTransport,
    )

    def pcts(ms):
        xs = sorted(ms)
        return {"p50_ms": nearest_rank(xs, 50), "p99_ms": nearest_rank(xs, 99)}

    fabric = {}
    payload = b"x" * 4096
    for backend in ("shared_dir", "socket"):
        root = tempfile.mkdtemp(prefix="smoke_fabric_", dir=_cache_dir())
        daemon = ExchangeDaemon().start() if backend == "socket" else None

        def make(pid=0, n=1):
            if daemon is not None:
                return SocketTransport(daemon.address, pid, n, timeout_s=60)
            return SharedDirTransport(root, pid, n, timeout_s=60)

        try:
            tr = make()
            lat = []
            for i in range(IG_STORE_ROUNDS):
                t1 = time.perf_counter()
                tr.put(f"pg.{i}", payload, overwrite=True)
                got = tr.get(f"pg.{i}")
                lat.append((time.perf_counter() - t1) * 1e3)
                assert got == payload
            a, b = make(0, 2), make(1, 2)
            arr = np.arange(1024, dtype=np.int64)
            ag = []
            peer = threading.Thread(target=lambda: [b.allgather(f"ag.{r}", arr * 10)
                                                    for r in range(IG_AG_ROUNDS)])
            peer.start()
            for r in range(IG_AG_ROUNDS):
                t1 = time.perf_counter()
                out = a.allgather(f"ag.{r}", arr)
                ag.append((time.perf_counter() - t1) * 1e3)
                assert len(out) == 2 and np.array_equal(out[1], arr * 10)
            peer.join(120)
            el = []
            for r in range(IG_ELECTIONS):
                t1 = time.perf_counter()
                won = make(0, 2).elect(f"lead.{r}", r)
                el.append((time.perf_counter() - t1) * 1e3)
                assert won == r
        finally:
            if daemon is not None:
                daemon.stop()
            shutil.rmtree(root, ignore_errors=True)
        fabric[backend] = {"put_get_4k": pcts(lat), "allgather_2_ranks": pcts(ag),
                           "elect": pcts(el)}
        say(f"ingest fabric [{backend}] " + json.dumps(fabric[backend]))
    cell["fabric"] = fabric
    obs.set_registry(None)
    return cell


# --------------------------------------------------------------------- #
# Serving (phase 20, slice 9a)
# --------------------------------------------------------------------- #
def query_step_bytes(b, v, turns):
    """Bytes each query step must move: ``b`` query ids (int32) over a
    ``v``-entry forest, the root chase taking ``turns`` turns (one host
    read each, and each gathers ``b`` forest entries); every input read once, every output
    written once; a gather reads only the entries it needs."""
    return {
        # the ids; the first gather and one gather of b entries a turn;
        # the roots written
        "serving.batch_roots": 4 * b * (turns + 3),
        # the forest read; the flat labels and the member counts written
        "serving.size_table": 12 * v,
        # the ids, b labels, b sizes; the answers written
        "serving.gather_sizes": 16 * b,
        # the ids, b table entries; the answers written
        "serving.gather": 12 * b,
    }


class _PacedClient:
    """The serving benches' client: a burst of queries every ``pace_s``
    for the whole ingest, each burst's answers collected before the next
    (``bench.py:bench_serving``'s closed loop). Every (query, answer) is
    kept for the oracle check; an answer-path error is recorded, never
    swallowed."""

    def __init__(self, server, make_burst, pace_s=SV_PACE_S):
        import threading

        self.server, self.make_burst, self.pace_s = server, make_burst, pace_s
        self.pairs, self.rejected, self.errors = [], 0, []
        self.thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        from gelly_streaming_tpu_torch.serving import Overloaded

        try:
            while not self.server.ingest_finished():
                sent = []
                for q in self.make_burst():
                    try:
                        sent.append((q, self.server.submit(q)))
                    except Overloaded:
                        self.rejected += 1
                self.pairs.extend((q, f.result(120)) for q, f in sent)
                time.sleep(self.pace_s)
        except BaseException as e:
            self.errors.append(e)

    def join(self):
        self.thread.join(300)
        if self.thread.is_alive() or self.errors:
            raise AssertionError(f"the serving client failed: {self.errors[:1]}")


def _query_pcts(stats, cls):
    q = stats["queries"].get(cls, {})
    return {"p50_ms": q.get("p50_ms"), "p99_ms": q.get("p99_ms"), "count": q.get("count", 0),
            "staleness_mean": q.get("staleness_mean"), "staleness_max": q.get("staleness_max")}


def _prefix_oracles(src, dst, n, window):
    """``oracle_labels`` of every window's edge prefix, built window by
    window: each step joins the window's edges to edges from every vertex
    to its label so far, so it costs a window, not the prefix."""
    ident = np.arange(n, dtype=np.int32)
    labels = ident
    out = []
    for w in range(0, len(src), window):
        labels = oracle_labels(np.concatenate([ident, src[w:w + window]]),
                               np.concatenate([labels.astype(np.int32), dst[w:w + window]]),
                               n).astype(np.int32)
        out.append(labels)
    return out


def _serving_bench(torch, windows=SV_WINDOWS, warm=True):
    """(a) ``bench.py:1704 bench_serving``, CC on the card: at its defaults
    (``windows=SV_WINDOWS``, a warm pass of each kind first), or over
    ``SV_STEADY_WINDOWS`` windows for the steady numbers."""
    from gelly_streaming_tpu_torch import CountWindow, SimpleEdgeStream
    from gelly_streaming_tpu_torch.datasets import IdentityDict
    from gelly_streaming_tpu_torch.library import ConnectedComponents
    from gelly_streaming_tpu_torch.obs.export import JsonlSink
    from gelly_streaming_tpu_torch.serving import ConnectedQuery, ServingStats, StreamServer
    from gelly_streaming_tpu_torch.serving import query as tq

    n_edges = SV_WINDOW * windows
    src, dst = make_stream(SV_VERTICES, n_edges, seed=SV_SEED)
    # the oracle: each window's prefix labels by scipy
    prefix = _prefix_oracles(src, dst, SV_VERTICES, SV_WINDOW)

    def stream():
        return SimpleEdgeStream((src, dst), window=CountWindow(SV_WINDOW),
                                vertex_dict=IdentityDict(SV_VERTICES), device=SV_DEVICE)

    def plain_pass():
        agg = ConnectedComponents()
        t0 = time.perf_counter()
        for _ in stream().aggregate(agg):
            pass
        agg.sync()
        return {"eps": n_edges / (time.perf_counter() - t0)}

    def served_pass():
        agg = ConnectedComponents()
        server = StreamServer(agg.servable(), stream(), max_pending=SV_MAX_PENDING)
        sink = JsonlSink()
        server.stats.attach_sink(sink)
        rng = np.random.default_rng(29)

        def burst():
            qu = rng.integers(0, SV_VERTICES, SV_BURST).tolist()
            qv = rng.integers(0, SV_VERTICES, SV_BURST).tolist()
            return [ConnectedQuery(a, b) for a, b in zip(qu, qv)]

        client = _PacedClient(server, burst)
        tq.HOST_READS = 0
        t0 = time.perf_counter()
        server.start()
        client.thread.start()
        server.join(600)
        agg.sync()
        dt = time.perf_counter() - t0
        client.join()
        server.close()
        stats = server.stats.snapshot()
        if ServingStats.from_events(sink.events).snapshot() != stats:
            raise AssertionError("the served pass's obs log does not replay to its stats")
        bad = sum(1 for q, a in client.pairs
                  if a.value != bool(prefix[a.window][q.u] == prefix[a.window][q.v]))
        if bad or not client.pairs:
            raise AssertionError(f"{bad} of {len(client.pairs)} served answers disagree with "
                                 "the DSU oracle at their snapshot's watermark")
        return {"eps": n_edges / dt, "answered": len(client.pairs),
                "rejected": client.rejected, "batches": stats["batches"],
                "host_reads_per_batch": tq.HOST_READS / max(1, stats["batches"]),
                "windows_answered": len({a.window for _q, a in client.pairs}),
                **_query_pcts(stats, "ConnectedQuery")}

    if warm:
        plain_pass()
        served_pass()  # warm both paths, then alternate
    plain, served = [], []
    for _ in range(SV_PAIRS):
        plain.append(plain_pass())
        served.append(served_pass())
    eps_plain = statistics.median(p["eps"] for p in plain)
    eps_served = statistics.median(s["eps"] for s in served)
    cell = {"windows": windows, "eps_no_server_all": [p["eps"] for p in plain],
            "eps_serving_all": [s["eps"] for s in served],
            "ingest_overhead_pct": 100.0 * (eps_plain - eps_served) / eps_plain,
            "served": served}
    say(f"serving (a) bench_serving, {windows} windows " + json.dumps(cell))
    return cell


def _served_cc_pass(torch, path, prefer_host, oracle_ids, hold=False):
    """One pass of the headline cell under a ``StreamServer`` with a paced
    client of ConnectedQuery + ComponentSizeQuery bursts on seen ids."""
    from gelly_streaming_tpu_torch import CountWindow, datasets
    from gelly_streaming_tpu_torch.library import ConnectedComponents
    from gelly_streaming_tpu_torch.serving import (
        ComponentSizeQuery,
        ConnectedQuery,
        QueryEngine,
        StreamServer,
    )
    from gelly_streaming_tpu_torch.serving import query as tq

    stream = datasets.stream_file(
        path, window=CountWindow(CC_WINDOW), vertex_dict=datasets.IdentityDict(CC_ID_BOUND),
        prefetch_depth=2, device=SV_DEVICE,
    )
    agg = ConnectedComponents()
    server = StreamServer(agg.servable(), stream, max_pending=SV_MAX_PENDING,
                          engine=QueryEngine(prefer_host=prefer_host))
    held = {}
    if hold:
        def keep_first(snap):
            if not held:
                held["snap"] = snap
                held["bytes"] = snap.payload["labels"].cpu().numpy().copy()

        server.store.add_listener(keep_first)
    rng = np.random.default_rng(31)
    half = SV_BURST // 2

    def burst():
        a, b, c = (oracle_ids[rng.integers(0, len(oracle_ids), half)].tolist() for _ in range(3))
        return ([ConnectedQuery(u, v) for u, v in zip(a, b)]
                + [ComponentSizeQuery(u) for u in c])

    client = _PacedClient(server, burst)
    tq.HOST_READS = 0
    t0 = time.perf_counter()
    server.start()
    client.thread.start()
    server.join(600)
    agg.sync()
    dt = time.perf_counter() - t0
    client.join()
    stats = server.stats.snapshot()
    reads = tq.HOST_READS / max(1, stats["batches"])
    return server, agg, held, {
        "seconds": dt, "answered": len(client.pairs), "rejected": client.rejected,
        "batches": stats["batches"], "host_reads_per_batch": reads,
        "connected": _query_pcts(stats, "ConnectedQuery"),
        "size": _query_pcts(stats, "ComponentSizeQuery"),
        "carry": agg._cc_mode,
    }


def _short_servables(torch):
    """(b) the other three servables, 4 windows each on their cells: the
    served answers equal each stream's own final view."""
    from gelly_streaming_tpu_torch import CountWindow
    from gelly_streaming_tpu_torch.library import DegreeDistribution, IncrementalPageRank
    from gelly_streaming_tpu_torch.library import BipartitenessCheck
    from gelly_streaming_tpu_torch.serving import (
        BipartiteQuery,
        DegreeQuery,
        RankQuery,
        StreamServer,
    )

    out = {}
    rng = np.random.default_rng(37)
    # DegreeServable on phase 6's event cell
    dd = DegreeDistribution(CountWindow(DD_WINDOW), device=SV_DEVICE)
    t0 = time.perf_counter()
    with StreamServer(dd.servable(), _dd_events()[:SV_SHORT_WINDOWS * DD_WINDOW]) as server:
        server.join(300)
        vs = rng.integers(0, DD_VERTICES, 512).tolist()
        got = [a.value for a in (server.ask(DegreeQuery(v), 60) for v in vs)]
        deg = dd.degrees()
        vd = dd._windower.vertex_dict
        want = [int(deg[c]) if c is not None and c < len(deg) else 0
                for c in (vd.lookup(v) for v in vs)]
    out["degrees"] = {"seconds": time.perf_counter() - t0, "equal": got == want}
    # RankServable on phase 9's cell (its 4 windows)
    src, dst = make_stream(PR_VERTICES, PR_EDGES, seed=PR_SEED)
    pr = IncrementalPageRank(tol=PR_TOL, max_iter=PR_MAX_ITER)
    t0 = time.perf_counter()
    with StreamServer(pr.servable(), _pr_stream(src, dst, device=SV_DEVICE)) as server:
        server.join(300)
        ranks = pr.ranks()
        vs = list(ranks)[:: max(1, len(ranks) // 512)]
        got = [server.ask(RankQuery(v), 60).value for v in vs]
    out["ranks"] = {"seconds": time.perf_counter() - t0,
                    "equal": got == [ranks[v] for v in vs]}
    # BipartitenessServable on phase 10's cell, its first 4 windows
    spec_edges = SV_SHORT_WINDOWS * CC_WINDOW
    from gelly_streaming_tpu_torch import datasets

    spec = datasets.CORPORA[CC_CORPUS]
    bsrc, bdst = rmat_oracle_edges(spec.surrogate_edges,
                                   int(spec.surrogate_vscale).bit_length() - 1)
    cols = (bsrc[:spec_edges].astype(np.int32), bdst[:spec_edges].astype(np.int32))
    t0 = time.perf_counter()
    with StreamServer(BipartitenessCheck().servable(), _bip_stream(cols, device=SV_DEVICE)) \
            as server:
        server.join(300)
        got = server.ask(BipartiteQuery(), 60).value
    final = _bip_pass(cols, windows=SV_SHORT_WINDOWS)[0][-1].success
    out["bipartiteness"] = {"seconds": time.perf_counter() - t0, "answer": got,
                            "equal": got["bipartite"] == final}
    say("serving (b) the other servables, 4 windows each " + json.dumps(out))
    if not all(r["equal"] for r in out.values()):
        raise AssertionError("a servable's answers disagree with its stream's final view")
    return out


def _query_steps(torch, canon):
    """The four query steps on the headline cell's final forest, at the
    shapes the served pass gives them: each step's ms a call between CUDA
    events over ``SV_STEP_REPS`` calls (the device timeline: a step that
    reads to the host includes its round trips), its host reads, its
    launches and kernel ms from a profile of one call (None where the
    profile shows no device event), its byte bound."""
    from torch.profiler import ProfilerActivity, profile

    from gelly_streaming_tpu_torch.serving import query as tq

    rng = np.random.default_rng(41)
    b = SV_BURST
    ids = torch.as_tensor(rng.integers(0, canon.shape[0], 2 * b).astype(np.int32),
                          device=canon.device)
    lab, sizes = tq._component_size_table(canon)
    steps = (("serving.batch_roots", lambda: tq._batch_roots(canon, ids)),
             ("serving.size_table", lambda: tq._component_size_table(canon)),
             ("serving.gather_sizes", lambda: tq._gather_sizes(lab, sizes, ids[:b])),
             ("serving.gather", lambda: tq._gather(canon, ids[:b])))
    table = {}
    for name, fn in steps:
        fn()  # warm
        torch.cuda.synchronize()
        before = tq.HOST_READS
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(SV_STEP_REPS):
            fn()
        end.record()
        torch.cuda.synchronize()
        reads = (tq.HOST_READS - before) / SV_STEP_REPS
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = [ev for ev in prof.events() if ev.device_type.name == "CUDA"]
        table[name] = {"ms": start.elapsed_time(end) / SV_STEP_REPS, "host_reads": reads,
                       "launches": len(events) or None,
                       "kernel_ms": sum(ev.time_range.elapsed_us() for ev in events) / 1e3
                       if events else None}
    turns = int(table["serving.batch_roots"]["host_reads"])
    nbytes = query_step_bytes(2 * b, int(canon.shape[0]), turns)
    nbytes["serving.gather_sizes"] = query_step_bytes(b, 0, 0)["serving.gather_sizes"]
    nbytes["serving.gather"] = query_step_bytes(b, 0, 0)["serving.gather"]
    for name, row in table.items():
        row["bytes"] = nbytes[name]
        row["bound_ms"] = nbytes[name] / HBM_BYTES_PER_S * 1e3
        row["bound_share"] = row["bound_ms"] / row["ms"] if row["ms"] else None
    say("serving query steps (per call, on the final 2^21 forest; roots over 512 ids, the "
        f"gathers over 256; ms between CUDA events over {SV_STEP_REPS} calls, launches and "
        "kernel ms from a profile of one call; bound by bytes) " + json.dumps(table))
    table["host_forms"] = _host_query_forms(torch, canon, ids)
    return table


def _host_query_forms(torch, canon, ids):
    """The host path's two forms on the same forest and ids, on this
    machine's CPU: the engine's numpy steps against the torch steps on CPU
    tensors (median ms of ``SV_HOST_REPS`` calls each). Equal answers."""
    from gelly_streaming_tpu_torch.serving import query as tq
    from gelly_streaming_tpu_torch.summaries.forest import resolve_flat_host

    lab_np, ids_np = canon.cpu().numpy(), ids.cpu().numpy().astype(np.int64)
    lab_t, ids_t = torch.from_numpy(lab_np), torch.from_numpy(ids_np)

    def ms(fn):
        fn()
        times = []
        for _ in range(SV_HOST_REPS):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    def size_np():
        flat = resolve_flat_host(lab_np)
        return flat, np.bincount(flat, minlength=len(lab_np))

    if not (np.array_equal(tq._host_batch_roots(lab_np, ids_np),
                           tq._batch_roots(lab_t, ids_t).numpy())
            and np.array_equal(size_np()[1], tq._component_size_table(lab_t)[1].numpy())):
        raise AssertionError("the host path's numpy and torch forms disagree")
    forms = {"batch_roots": {"numpy_ms": ms(lambda: tq._host_batch_roots(lab_np, ids_np)),
                             "torch_cpu_ms": ms(lambda: tq._batch_roots(lab_t, ids_t))},
             "size_table": {"numpy_ms": ms(size_np),
                            "torch_cpu_ms": ms(lambda: tq._component_size_table(lab_t))}}
    say(f"serving host path forms (this machine's CPU, {torch.get_num_threads()} torch "
        f"threads; median of {SV_HOST_REPS} calls) " + json.dumps(forms))
    return forms


def phase_serving(torch, oracle):
    """Phase 20: the serving tier on the card."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from gelly_streaming_tpu_torch import datasets
    from gelly_streaming_tpu_torch.ops import sage_kernels as sk
    from gelly_streaming_tpu_torch.resilience import chaos
    from gelly_streaming_tpu_torch.serving import ComponentSizeQuery, ConnectedQuery

    sk.LAUNCHES = 0
    cell = {"bench_serving": _serving_bench(torch),
            "bench_serving_steady": _serving_bench(torch, SV_STEADY_WINDOWS, warm=False)}

    # (b) the headline cell under a server, both query paths
    path, _ = datasets.ensure_corpus(CC_CORPUS)
    n_edges = datasets.CORPORA[CC_CORPUS].surrogate_edges
    ids = oracle["ids"]
    full = np.full(CC_ID_BOUND, -1, np.int64)
    full[ids] = oracle["labels"]
    size_of = np.bincount(oracle["labels"], minlength=CC_ID_BOUND)
    unserved, _, _ = _cc_pass(torch, path)
    b = {"eps_unserved": n_edges / unserved["seconds"]}
    for prefer_host in ("auto", True):
        server, agg, held, r = _served_cc_pass(torch, path, prefer_host, ids,
                                               hold=prefer_host == "auto")
        try:
            rng = np.random.default_rng(43)
            us, vs = (ids[rng.integers(0, len(ids), 2048)].tolist() for _ in range(2))
            conn = [server.ask(ConnectedQuery(u, v), 60) for u, v in zip(us, vs)]
            size = [server.ask(ComponentSizeQuery(u), 60) for u in us]
            ok = (all(a.staleness == 0 for a in conn + size)
                  and [a.value for a in conn] == [bool(full[u] == full[v]) for u, v in zip(us, vs)]
                  and [a.value for a in size] == [int(size_of[full[u]]) for u in us])
            if held:
                snap = held["snap"]
                ok = ok and np.array_equal(snap.payload["labels"].cpu().numpy(), held["bytes"])
                r["held_snapshot_version"] = snap.version
            if prefer_host == "auto":
                canon = server.snapshot().payload["labels"]
        finally:
            server.close()
        r["eps"] = n_edges / r["seconds"]
        r["final_equal_scipy"] = ok
        b["device_path" if prefer_host == "auto" else "host_path"] = r
        if not ok or r["carry"] != "forest":
            raise AssertionError(f"the served headline cell (prefer_host={prefer_host}) "
                                 f"disagrees with scipy or its held snapshot changed: {r}")
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        server, _, _, r = _served_cc_pass(torch, path, "auto", ids)
        server.close()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    share = profile_pass(torch, lambda: None, wall, prof=prof)
    # the profiler stretches the pass many times over: the device time it
    # saw is also set against the unprofiled served pass's wall
    b["profiled_busy_share"] = share
    b["profiled_pass_s"] = wall
    if share is not None:
        b["device_busy_ms"] = share * wall * 1e3
        b["device_busy_over_unprofiled_pass"] = share * wall / b["device_path"]["seconds"]
    say("serving (b) headline cell served " + json.dumps(b))
    cell["headline"] = b
    cell["query_steps"] = _query_steps(torch, canon)
    cell["servables"] = _short_servables(torch)

    # (c) the RPC failover scenario, both replicas' tables on the card
    root = tempfile.mkdtemp(prefix="smoke_rpc_", dir=_cache_dir())
    try:
        doc = chaos.run_rpc_scenario(root, device=SV_DEVICE, log=say, **SV_RPC)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    att = doc["attribution"]
    c = {k: doc.get(k) for k in ("ok", "batches", "queries", "failures", "deadline_expired",
                                 "primary_rc", "outage_s", "promoted", "flight_dumps",
                                 "steady", "promotion_window", "serving_promotion_seconds")}
    c["traces_completed"] = att["traces_completed"]
    c["kill_crossing_traces"] = att["kill_crossing_traces"]
    c["coverage_p50"] = att["steady"]["coverage_p50"]
    say("serving (c) run_rpc_scenario " + json.dumps(c))
    if not (doc["ok"] and doc["failures"] == 0 and doc["promoted"] and doc["flight_dumps"]
            and att["traces_completed"] == doc["batches"]):
        raise AssertionError(f"the RPC failover scenario failed: {doc.get('reason')}")
    cell["rpc"] = c
    say(f"serving fused_sage_matmul launches in phase 20: {sk.LAUNCHES} (the serving path "
        "has no hand-written kernel; its query steps are PyTorch operations)")
    return cell


def _full_pull_frame_bytes(rows):
    """Bytes of the reply frame's body that carries one full summary pull of
    ``rows`` rows (the doc ``QueryEngine.summary_pull`` answers, inside the
    wire's answer envelope)."""
    from gelly_streaming_tpu_torch.serving.query import encode_pull_doc

    col = np.zeros(rows, np.int64)
    doc = encode_pull_doc(col, col, kind="full")
    env = {"id": "0" * 32, "status": "ok",
           "answers": [["ok", doc, 0, 0, 0, 0, -1, 0, "0" * 16]]}
    return len(json.dumps(env))


def _sharded_size():
    """(n_vertices, n_edges, cuts) for cell (b): from 2^21 and 2^22, halved
    together while the churn cell's full pull of its 4x keyspace (every slot
    of the shard's table, 16 bytes a row in base64 twice over) would exceed
    the one frame a client reads; such a pull fails, and the cell's
    converge-and-oracle step with it."""
    from gelly_streaming_tpu_torch.fabric.wire import DEFAULT_MAX_FRAME

    nv, ne, cuts = RT_SH_VERTICES, RT_SH_EDGES, []
    while True:
        size = _full_pull_frame_bytes(4 * nv)
        if size <= DEFAULT_MAX_FRAME:
            return nv, ne, cuts
        cuts.append(f"cut: n_vertices {nv} -> {nv // 2}, n_edges {ne} -> {ne // 2}: c3's "
                    f"full pull of {4 * nv} rows is a {size}-byte frame, over the wire's "
                    f"{DEFAULT_MAX_FRAME}-byte bound (fabric/wire.py:DEFAULT_MAX_FRAME)")
        nv, ne = nv // 2, ne // 2


def _router_host_work():
    """(d) What one router's host work costs at the headline's 2^21 ids, on
    this machine's CPU: the two shards' forests of 2^22 edges (the replicas'
    host fold), one full pull's encode and decode, the cross-shard merge of
    the two tables, and one delta apply of a 1 % churn bump (the sharded
    scenario's churn rate), each timed once with the host clock."""
    from gelly_streaming_tpu_torch.core.ingest import partition_edges_by_vertex
    from gelly_streaming_tpu_torch.serving.query import encode_pull_doc
    from gelly_streaming_tpu_torch.serving.router import decode_pull, demo_shard_edges
    from gelly_streaming_tpu_torch.summaries.forest import (
        apply_forest_delta_host,
        fold_edges_host,
        merge_forest_tables_host,
        resolve_flat_host,
    )

    nv, ne = RT_SH_VERTICES, RT_SH_EDGES
    src, dst = demo_shard_edges(nv, ne, RT_SEED)
    t0 = time.perf_counter()
    tables = [fold_edges_host(np.arange(nv, dtype=np.int32), s_, d_)
              for s_, d_, _v in partition_edges_by_vertex(src, dst, None, RT_SHARDS)]
    fold_s = time.perf_counter() - t0
    ids = np.arange(nv, dtype=np.int64)
    t0 = time.perf_counter()
    doc = encode_pull_doc(ids, tables[0].astype(np.int64), kind="full")
    encode_s = time.perf_counter() - t0
    frame = len(json.dumps(doc))
    t0 = time.perf_counter()
    dec = decode_pull(doc)
    decode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    merged = merge_forest_tables_host(tables)
    merge_s = time.perf_counter() - t0
    lab = merged.astype(np.int64)
    sizes = np.bincount(merged, minlength=nv).astype(np.int64)
    cs, cd = demo_shard_edges(nv, max(1, int(nv * 0.01) // 2), RT_SEED + 40)
    t0 = time.perf_counter()
    touched = apply_forest_delta_host(lab, sizes, cs, cd)
    delta_s = time.perf_counter() - t0
    whole = fold_edges_host(merged, cs, cd)
    d = {"n_vertices": nv, "n_edges": ne, "shard_fold_s": fold_s,
         "pull_encode_s": encode_s, "pull_decode_s": decode_s, "pull_doc_bytes": frame,
         "merge_s": merge_s, "delta_edges": len(cs), "delta_apply_s": delta_s,
         "delta_touched_roots": len(touched),
         "decode_equal": bool(np.array_equal(dec["r"], tables[0])),
         "delta_equal_fold": bool(np.array_equal(resolve_flat_host(lab), whole))}
    say(f"routing (d) router host work at {nv} ids " + json.dumps(d))
    if not (d["decode_equal"] and d["delta_equal_fold"]):
        raise AssertionError(f"the router's host forms disagree at 2^21: {d}")
    return d


def phase_routing(torch):
    """Phase 21: the routing tier on the card (slice 9b)."""
    import tempfile

    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    from gelly_streaming_tpu_torch.example import sharded_ingest_serving
    from gelly_streaming_tpu_torch.ops import sage_kernels as sk
    from gelly_streaming_tpu_torch.resilience import chaos

    sk.LAUNCHES = 0
    cell = {}

    # (a) the sharded example: sharded socket ingest -> CC on the card -> served
    t0 = time.perf_counter()
    lines = sharded_ingest_serving.run(RT_SHARDS, RT_EX_WINDOW, RT_EX_EDGES,
                                       n_vertices=RT_EX_VERTICES, seed=RT_SEED,
                                       device=RT_DEVICE)
    wall = time.perf_counter() - t0
    rng = np.random.default_rng(RT_SEED)  # the example's own draws, in its order
    src = rng.integers(0, RT_EX_VERTICES, RT_EX_EDGES, dtype=np.int64)
    dst = rng.integers(0, RT_EX_VERTICES, RT_EX_EDGES, dtype=np.int64)
    pairs = rng.integers(0, RT_EX_VERTICES, (4, 2))
    adj = sp.coo_matrix((np.ones(RT_EX_EDGES, np.int8), (src, dst)),
                        shape=(RT_EX_VERTICES, RT_EX_VERTICES))
    _, comp = connected_components(adj, directed=True, connection="weak")
    finals = [ln for ln in lines if ln.startswith("final ")]
    want = [f"final connected({int(u)},{int(v)}) = {bool(comp[u] == comp[v])}"
            for u, v in pairs]
    a = {"edges_per_s": RT_EX_EDGES / wall, "seconds": wall, "lines": lines,
         "final_equal_scipy": [ln.split(" [")[0] for ln in finals] == want}
    say("routing (a) sharded_ingest_serving " + json.dumps(a))
    if not a["final_equal_scipy"]:
        raise AssertionError(f"the sharded example's answers disagree with scipy: {finals} "
                             f"!= {want}")
    cell["example"] = a

    # (b) the sharded-serving scenario, every shard replica on the card
    nv, ne, cuts = _sharded_size()
    for c in cuts:
        say("routing (b) " + c)
    root = tempfile.mkdtemp(prefix="smoke_sharded_", dir=_cache_dir())
    t0 = time.perf_counter()
    try:
        doc = chaos.run_sharded_scenario(root, n_vertices=nv, n_edges=ne, window=RT_SH_WINDOW,
                                         measure_s=RT_SH_MEASURE_S, device=RT_DEVICE, log=say)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    wall = time.perf_counter() - t0
    sr, z, kill, churn = doc["single_replica"], doc["zipf"], doc["shard_kill"], doc["churn"]
    stats = doc["router_cache_stats"] or {}
    lookups = stats.get("cache_hits", 0) + stats.get("cache_misses", 0)
    pick = ("qps", "p50_ms", "p99_ms", "failures", "deadline_expired")
    b = {
        "config": doc["config"], "cuts": len(cuts), "seconds": wall,
        "c1_direct": {k: {f: sr[k][f] for f in pick} for k in ("uniform", "zipf")},
        "c2_cache_off": {f: z["cache_off"][f] for f in pick},
        "c2_cache_on": {f: z["cache_on"][f] for f in pick},
        "c2_hot_set": {f: z["hot_set_cache_on"][f] for f in pick},
        "oracle": doc["oracle"], "trace": doc["trace"]["joined_trace"],
        "cache_hit_rate": stats.get("cache_hits", 0) / lookups if lookups else None,
        "cache_stats": {k: stats.get(k) for k in ("cache_hits", "cache_misses", "pulls",
                                                  "merges_full", "merge_s_full",
                                                  "pull_bytes_full")},
        "kill": {k: kill[k] for k in ("affected", "unaffected", "promoted", "primary_rc")},
        "churn": {k: churn[k] for k in ("delta_bytes_per_refresh", "full_bytes_per_refresh",
                                        "delta_merge_s_per_refresh", "full_merge_s_per_refresh",
                                        "bytes_x", "merge_x", "oracle_mismatches",
                                        "converged", "churn_ok")},
        "scaling": doc["scaling"], "headline": doc["headline"], "ok": doc["ok"],
        "host_cores": os.cpu_count(),
    }
    say("routing (b) run_sharded_scenario " + json.dumps(b))
    load_fail = sum(d["failures"] + d["deadline_expired"] + len(d["errors"])
                    for d in (sr["uniform"], sr["zipf"], z["cache_off"], z["cache_on"],
                              z["hot_set_cache_on"]))
    if not (doc["oracle"]["mismatches"] == 0 and load_fail == 0
            and kill["affected"]["failures"] == 0 and kill["unaffected"]["failures"] == 0
            and not kill["driver_errors"] and kill["promoted"]
            and doc["trace"]["joined_trace"] is not None
            and churn["oracle_mismatches"] == 0 and churn["converged"] == [True, True]
            and not churn["driver_errors"]):
        raise AssertionError(f"the sharded-serving scenario failed a gate: load failures "
                             f"{load_fail}, {doc.get('reason')}")
    cell["sharded"] = b

    # (c) the storm at bench.py --storm --smoke's geometry, replicas on the card
    root = tempfile.mkdtemp(prefix="smoke_storm_", dir=_cache_dir())
    t0 = time.perf_counter()
    try:
        doc = chaos.run_storm_scenario(root, device=RT_DEVICE, log=say, **RT_STORM)
        try:
            with open(os.path.join(root, "router.b.meta.json")) as f:
                survivor = json.load(f)
        except (OSError, ValueError):
            survivor = {}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    wall = time.perf_counter() - t0
    c = {"config": doc["config"], "seconds": wall,
         "phases": {n: {k: v[k] for k in ("batches", "failures", "p50_ms", "p99_ms")}
                    for n, v in doc["load"].items()},
         "load_total": doc["load_total"], "oracle": doc["oracle"],
         "txn": {k: doc["txn"][k] for k in ("txns", "committed", "expired", "violations",
                                             "spanning", "zero_violations", "driver_errors")},
         "trace": doc["trace"], "storm": {k: v for k, v in doc["storm"].items() if k != "phases"},
         "surviving_router_epoch": survivor.get("epoch"),
         "retune": {k: doc["retune"][k] for k in ("total_moves", "worst_reverts_per_phase")},
         "ok": doc["ok"]}
    say("routing (c) run_storm_scenario " + json.dumps(c))
    st = doc["storm"]
    if not (all(v["failures"] == 0 for v in doc["load"].values())
            and doc["load_total"]["failures"] == 0 and not doc["load_total"]["driver_errors"]
            and st["promoted"] and st["split_adopted"] and st["survivor_alive"]
            and doc["oracle"]["mismatches"] == 0 and doc["txn"]["violations"] == 0
            and not doc["txn"]["driver_errors"] and doc["trace"]["joined_trace"] is not None
            and survivor.get("epoch") == 1):
        raise AssertionError(f"the storm scenario failed a gate: {doc.get('reason')}")
    cell["storm"] = c
    cell["router_host_2p21"] = _router_host_work()
    say(f"routing fused_sage_matmul launches in phase 21: {sk.LAUNCHES} (the routing tier "
        "has no hand-written kernel; the replicas' query steps are PyTorch operations and "
        "the routers' merges host numpy)")
    cell["fused_sage_matmul_launches"] = sk.LAUNCHES
    return cell


def _mesh_collectives(torch, mesh):
    """Every ``comm`` collective inside ``shard_map`` on CC's table size,
    each held against its local form (what one device computes from every
    rank's inputs; the check is also the warm call), and its host-clock ms
    a call (synchronized, the median of ``MESH_COLL_REPS``). Rank r
    contributes ``base + r``, so every reduction's answer is known."""
    import torch.distributed as dist

    from gelly_streaming_tpu_torch.parallel import comm
    from gelly_streaming_tpu_torch.parallel.mesh import EDGE_AXIS, P, mesh_shape

    p = mesh_shape(mesh)[EDGE_AXIS]
    r = dist.get_rank()
    n, e = MESH_TABLE, MESH_COLL_EDGES
    gen = torch.Generator(device="cuda").manual_seed(3)
    base = torch.randint(0, 1 << 20, (n,), generator=gen, device="cuda", dtype=torch.int32)
    mine = base + r
    ids = torch.randint(0, n, (e,), generator=gen, device="cuda", dtype=torch.int32)
    vals = torch.randint(0, 1 << 10, (e,), generator=gen, device="cuda", dtype=torch.int32)
    seg_sum = torch.zeros(n, dtype=torch.int32, device="cuda").index_add_(0, ids.long(), vals)
    seg_min = torch.full((n,), torch.iinfo(torch.int32).max, dtype=torch.int32,
                         device="cuda").scatter_reduce_(0, ids.long(), vals, "amin")
    ops = {
        "all_reduce_sum": (lambda: comm.all_reduce(mine, EDGE_AXIS),
                           p * base + p * (p - 1) // 2),
        "all_reduce_min": (lambda: comm.all_reduce(mine, EDGE_AXIS, op="min"), base),
        "all_reduce_max": (lambda: comm.all_reduce(mine, EDGE_AXIS, op="max"), base + p - 1),
        "all_gather": (lambda: comm.all_gather(mine, EDGE_AXIS),
                       torch.stack([base + q for q in range(p)])),
        "tree_all_reduce_d2": (lambda: comm.tree_all_reduce(mine, EDGE_AXIS, torch.minimum, p, 2),
                               base),
    }
    out = {}
    with comm.bind(mesh):
        for name, (fn, want) in ops.items():
            ok = bool(torch.equal(fn(), want))
            out[name] = (ok, _median_ms(fn, torch, MESH_COLL_REPS))
    # the sharded segment ops take edge-sharded columns: shard_map slices
    for name, fn, want in (("sharded_segment_sum", comm.sharded_segment_sum, seg_sum),
                           ("sharded_segment_min", comm.sharded_segment_min, seg_min)):
        run = comm.shard_map(lambda v, i, f=fn: f(v, i, n, EDGE_AXIS), mesh,
                             (P(EDGE_AXIS), P(EDGE_AXIS)), P())
        ok = bool(torch.equal(run(vals, ids), want))
        out[name] = (ok, _median_ms(lambda: run(vals, ids), torch, MESH_COLL_REPS))
    return out


def _mesh_inputs(work):
    """The (b) cells' inputs, made once by the parent and read by every
    rank: phase 5's corpus prefix, phase 9's PageRank stream, a
    bipartiteness stream, phase 7's window 0 and phase 4's stream."""
    cc_src, cc_dst = _corpus_prefix(MESH_CC_EDGES)
    pr_src, pr_dst = make_stream(PR_VERTICES, PR_EDGES, seed=PR_SEED)
    bv, be, _, bseed = MESH_BIP
    bp_src, bp_dst = make_stream(bv, be, seed=bseed)
    tr_src, tr_dst = make_stream(TRI_VERTICES, TRI_WINDOWS * TRI_WINDOW, seed=TRI_SEED)
    sg_src, sg_dst = make_stream(N_VERTICES, WINDOW * N_WINDOWS, seed=STREAM_SEED)
    cols = dict(cc_src=cc_src, cc_dst=cc_dst, pr_src=pr_src, pr_dst=pr_dst, bp_src=bp_src,
                bp_dst=bp_dst, tr_src=tr_src[:TRI_WINDOW], tr_dst=tr_dst[:TRI_WINDOW],
                sg_src=sg_src, sg_dst=sg_dst)
    np.savez(os.path.join(work, "inputs.npz"), **cols)
    return cols


def _sage_params(torch):
    """Config #5's parameters and feature table on the card, from seeds 0
    and 1 (phases 4 and 22)."""
    from gelly_streaming_tpu_torch.models import TableFeatureSource, init_graphsage

    params = init_graphsage(
        DIMS, torch.bfloat16, generator=torch.Generator().manual_seed(0), device="cuda"
    )
    table = TableFeatureSource(
        torch.randn((N_VERTICES, DIMS[0]), generator=torch.Generator().manual_seed(1))
        .to(torch.bfloat16), device="cuda",
    )
    return params, table


def _mesh_workloads(torch, mesh, cols):
    """The (b) cells on ``mesh`` (None: one device, no mesh): CC bulk and
    tree with the forest carry, PageRank, bipartiteness, the sharded
    triangle count and the sharded GraphSAGE forward. Returns host arrays
    and the CC passes' seconds."""
    from gelly_streaming_tpu_torch import CountWindow, SimpleEdgeStream
    from gelly_streaming_tpu_torch.datasets import IdentityDict
    from gelly_streaming_tpu_torch.library import (
        BipartitenessCheck,
        ConnectedComponents,
        ConnectedComponentsTree,
        IncrementalPageRank,
    )
    from gelly_streaming_tpu_torch.library.triangles import _oriented_degree_bucket
    from gelly_streaming_tpu_torch.models import StreamingGraphSAGE
    from gelly_streaming_tpu_torch.ops import triangles as ttri

    def stream(src, dst, window, bound):
        return SimpleEdgeStream((src, dst), window=CountWindow(window),
                                vertex_dict=IdentityDict(bound), device="cuda")

    res = {}
    for name, cls in (("cc_bulk", ConnectedComponents), ("cc_tree", ConnectedComponentsTree)):
        for _ in range(2):  # a warm pass, then the timed one
            agg = cls(carry="forest", mesh=mesh)
            t0 = time.perf_counter()
            last = None
            for last in stream(cols["cc_src"], cols["cc_dst"], CC_WINDOW,
                               CC_ID_BOUND).aggregate(agg):
                pass
            agg.sync()
            seconds = time.perf_counter() - t0
        res[name] = (last.labels(), seconds, agg._cc_mode)
    pr = IncrementalPageRank(tol=PR_TOL, max_iter=PR_MAX_ITER, mesh=mesh)
    ems = list(pr.run(stream(cols["pr_src"], cols["pr_dst"], PR_WINDOW, PR_VERTICES)))
    res["pagerank"] = (pr._carry[2].cpu().numpy(), [int(e.iterations) for e in ems])
    bv, _, bw, _ = MESH_BIP
    bip = [c.success for c in stream(cols["bp_src"], cols["bp_dst"], bw, bv)
           .aggregate(BipartitenessCheck(mesh=mesh))]
    # the same edges made bipartite: (u & ~1, v | 1)
    bip2 = [c.success for c in stream(cols["bp_src"] & ~1, cols["bp_dst"] | 1, bw, bv)
            .aggregate(BipartitenessCheck(mesh=mesh))]
    res["bipartite"] = (bip, bip2)
    s = torch.from_numpy(cols["tr_src"].astype(np.int32)).cuda()
    d = torch.from_numpy(cols["tr_dst"].astype(np.int32)).cuda()
    m = torch.ones(s.shape[0], dtype=torch.bool, device="cuda")
    width = _oriented_degree_bucket(cols["tr_src"], cols["tr_dst"], TRI_VERTICES)
    if mesh is None:
        total, counts = ttri.window_triangle_count(s, d, m, TRI_VERTICES, width)
    else:
        total, counts = ttri.window_triangle_count_sharded(s, d, m, TRI_VERTICES, width, mesh)
    res["triangles"] = (int(total), counts.cpu().numpy())
    params, table = _sage_params(torch)
    sage = StreamingGraphSAGE(params, feature_dim=DIMS[0], mesh=mesh)
    outs = list(sage.run(stream(cols["sg_src"], cols["sg_dst"], WINDOW, N_VERTICES), table))
    res["sage"] = outs[-1].float().cpu().numpy()
    return res


def _mesh_rank(rank, world, init, work, backend):
    """One rank of a (b) or (c) world: join the group (gloo: every rank's
    tensors on card 0; NCCL: rank r on card r), run the collectives and
    the workloads on the mesh, and pickle the results."""
    import pickle

    import torch
    import torch.distributed as dist

    from gelly_streaming_tpu_torch.ops import sage_kernels as sk
    from gelly_streaming_tpu_torch.parallel import comm, make_mesh, multihost

    device = "cuda:0" if backend == "gloo" else f"cuda:{rank}"
    multihost.initialize(init, world, rank, device=device, backend=backend,
                         timeout_s=MESH_TIMEOUT_S)
    mesh = make_mesh(world, device="cuda")
    cols = dict(np.load(os.path.join(work, "inputs.npz")))
    comm.reset_counters()
    sk.LAUNCHES = 0
    out = {"collectives": _mesh_collectives(torch, mesh)}
    out.update(_mesh_workloads(torch, mesh, cols))
    out["calls"] = dict(comm.CALLS)
    out["staged"] = dict(comm.STAGED)
    out["staged_bytes"] = dict(comm.STAGED_BYTES)
    out["launches"] = sk.LAUNCHES
    with open(os.path.join(work, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def phase_mesh(torch):
    """Slice 6 on the card: (a) an NCCL world of one, (b) gloo worlds of 2
    and 4 ranks holding CUDA tensors on card 0, and (c) where there are
    more cards, NCCL worlds of 2 and 4 ranks, one card each."""
    import tempfile

    import torch.distributed as dist

    from gelly_streaming_tpu_torch.ops import sage_kernels as sk
    from gelly_streaming_tpu_torch.parallel import comm, make_mesh, multihost

    # (a) NCCL, a world of one on cuda:0
    multihost.initialize(device="cuda", timeout_s=MESH_TIMEOUT_S)
    mesh = make_mesh(1, device="cuda")
    say(f"mesh (a): backend {dist.get_backend()}, world {dist.get_world_size()}, "
        f"mesh {mesh}")
    coll = _mesh_collectives(torch, mesh)
    for name, (ok, ms) in coll.items():
        say(f"mesh (a) {dist.get_backend()} width 1: {name} on {MESH_TABLE} entries: "
            f"{'equal to its local form' if ok else 'FAIL'}, {ms:.4f} ms a call")
    if not all(ok for ok, _ in coll.values()):
        raise AssertionError("a collective disagrees with its local form")
    # the sharded forward at config #5's width against the forward without
    # a mesh: bit for bit under deterministic algorithms (index_add_ then
    # sums in a fixed order)
    src, dst = make_stream(N_VERTICES, WINDOW * N_WINDOWS, seed=STREAM_SEED)
    params, table = _sage_params(torch)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        plain = _run_slice(torch, src, dst, params, table)
        sk.LAUNCHES = 0
        sk.LAUNCHES_BY_VARIANT.update(tc=0, simt=0)
        comm.reset_counters()
        sharded = _run_slice(torch, src, dst, params, table, mesh=mesh)
        torch.cuda.synchronize()
        launches, by_variant = sk.LAUNCHES, dict(sk.LAUNCHES_BY_VARIANT)
    finally:
        torch.use_deterministic_algorithms(False)
    same = len(sharded) == len(plain) == N_WINDOWS and all(
        torch.equal(a, b) for a, b in zip(sharded, plain))
    say(f"mesh (a) sharded GraphSAGE forward (config #5, {N_WINDOWS} windows): "
        f"fused_sage_matmul launches {launches} {by_variant}, all-reduces "
        f"{comm.CALLS['all_reduce']}, {'bit for bit equal' if same else 'FAIL'} to the "
        "forward without a mesh")
    if not same or launches <= 0 or by_variant["tc"] != 2 * N_WINDOWS:
        raise AssertionError("the sharded forward differs or did not launch the kernel")
    del plain, sharded
    dist.destroy_process_group()

    # (b) gloo worlds of 2 and 4 ranks, every rank's tensors on the card
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        cols = _mesh_inputs(work)
        base = _mesh_workloads(torch, None, cols)
        say(f"mesh (b) inputs and the width-1 run: {time.perf_counter() - t0:.1f} s")
        oracle = _mesh_oracles(cols)
        _mesh_check(base, oracle, base, "width 1")
        _mesh_worlds(work, base, oracle, "gloo", MESH_WIDTHS)
        # (c) with more cards: NCCL worlds, one card a rank
        cards = torch.cuda.device_count()
        widths = [w for w in MESH_WIDTHS if w <= cards]
        if widths:
            _mesh_worlds(work, base, oracle, "nccl", widths)
        else:
            say(f"mesh (c): {cards} card: no NCCL world wider than 1 (NCCL refuses two "
                "ranks on one card)")
    return {"launches": launches}


def _mesh_worlds(work, base, oracle, backend, widths):
    """Spawn a world of each width on ``backend``, check every rank against
    scipy, the width-1 run and each other, and print the transport."""
    import pickle

    import torch.multiprocessing as mp

    for world in widths:
        t1 = time.perf_counter()
        init = "file://" + os.path.join(work, f"store-{backend}{world}")
        mp.start_processes(_mesh_rank, args=(world, init, work, backend), nprocs=world,
                           join=True, start_method="spawn")
        ranks = []
        for r in range(world):
            with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
        tag = f"mesh {backend} width {world}"
        say(f"{tag}: {time.perf_counter() - t1:.1f} s")
        for r, res in enumerate(ranks):
            _mesh_check(res, oracle, base, f"{backend} width {world} rank {r}")
            if not all(ok for ok, _ in res["collectives"].values()):
                raise AssertionError(f"{tag} rank {r}: a collective disagrees with its "
                                     "local form")
        for a in ranks[1:]:
            for key in ("cc_bulk", "cc_tree"):
                if not _labels_equal(a[key][0], ranks[0][key][0]):
                    raise AssertionError(f"{tag}: ranks disagree on {key}")
            err = float(np.max(np.abs(a["pagerank"][0] - ranks[0]["pagerank"][0])))
            if err > PR_RANK_TOL or not np.array_equal(a["sage"], ranks[0]["sage"]):
                raise AssertionError(f"{tag}: ranks disagree (ranks {err:.2e})")
        r0 = ranks[0]
        for name, (_, ms) in r0["collectives"].items():
            say(f"{tag}: {name} on {MESH_TABLE} entries, {ms:.4f} ms a call")
        for key in ("cc_bulk", "cc_tree"):
            say(f"{tag}: {key} forest carry {MESH_CC_EDGES / r0[key][1] / 1e6:.3f} M edges/s "
                f"({r0[key][1]:.3f} s after a warm pass; width 1 "
                f"{MESH_CC_EDGES / base[key][1] / 1e6:.3f} M)")
        say(f"{tag}: rank 0 collectives {r0['calls']}, staged through host memory "
            f"{r0['staged']} ({r0['staged_bytes']} bytes each way), fused_sage_matmul "
            f"launches {r0['launches']}")
        if r0["launches"] <= 0:
            raise AssertionError("the sharded forward did not launch the kernel")


def _mesh_oracles(cols):
    """scipy's answers for the (b) cells."""
    src, dst = cols["cc_src"], cols["cc_dst"]
    want = oracle_labels(src, dst, CC_ID_BOUND)
    seen = np.zeros(CC_ID_BOUND, bool)
    seen[src] = True
    seen[dst] = True
    ids = np.nonzero(seen)[0]
    ranks = pagerank_oracle(cols["pr_src"], cols["pr_dst"], PR_WINDOW, PR_VERTICES)[0]
    bv = MESH_BIP[0]
    return {
        "cc": (ids, want[ids]),
        "pagerank": ranks,
        "bipartite": bipartite_oracle(cols["bp_src"], cols["bp_dst"], bv),
        "triangles": oracle_triangles(cols["tr_src"], cols["tr_dst"], TRI_VERTICES),
    }


def _mesh_check(res, oracle, base, label):
    """One run's (b) results against scipy and against the width-1 run:
    integers exact, ranks within ``PR_RANK_TOL``, embeddings within
    ``SLICE_TOL`` of the largest."""
    for key in ("cc_bulk", "cc_tree"):
        labels, _, mode = res[key]
        if mode != "forest" or not _labels_equal(labels, oracle["cc"]):
            raise AssertionError(f"{label}: {key} (carry {mode}) differs from scipy")
    rank_err = float(np.max(np.abs(res["pagerank"][0][:len(oracle["pagerank"])]
                                   - oracle["pagerank"])))
    bip, bip2 = res["bipartite"]
    verdict = bip[-1]
    tri_total, tri_counts = res["triangles"]
    sage_err = float(np.max(np.abs(res["sage"] - base["sage"])))
    sage_ref = float(np.max(np.abs(base["sage"])))
    say(f"mesh {label}: cc bulk and tree exact against scipy "
        f"({len(oracle['cc'][0])} vertices); pagerank max |r - scipy| {rank_err:.2e}, "
        f"iterations {res['pagerank'][1]}; bipartite {verdict} (scipy {oracle['bipartite']}), "
        f"made-bipartite {bip2[-1]}; triangles {tri_total} (scipy {oracle['triangles']}); "
        f"sage max_abs_err {sage_err:.3e} of max|ref| {sage_ref:.3e}")
    if rank_err > PR_RANK_TOL:
        raise AssertionError(f"{label}: PageRank is {rank_err:.2e} from scipy")
    if verdict != oracle["bipartite"] or not all(bip2) or bip != base["bipartite"][0]:
        raise AssertionError(f"{label}: a bipartiteness verdict differs from scipy")
    if tri_total != oracle["triangles"] or not np.array_equal(tri_counts, base["triangles"][1]):
        raise AssertionError(f"{label}: the triangle count differs")
    if not sage_err <= SLICE_TOL * sage_ref:
        raise AssertionError(f"{label}: the sharded forward differs from the width-1 run")


# --------------------------------------------------------------------- #
# Training (phase 23)
# --------------------------------------------------------------------- #
def train_step_bytes(v, e, dims, family, opt, remat):
    """Least work of one training step at config #5: the bytes the step must
    move (each input read once, each output written once: the features, the
    int32 edge columns, the mask, the f32 targets, the bf16 parameters in
    and out, Adam's three f32 buffers in and out, the loss) and the matmul
    operations, each at the peak of its type: a layer's forward 2VFO for
    each of its weights (SAGE's two in bf16 on the tensor cores, GCN's one
    in f32), run twice with remat; the weights' gradients as many, and the
    inputs' gradients for every layer but the first, in f32 (the backward's
    products are f32, TF32 off)."""
    mats = 2 if family == "sage" else 1
    n_params = sum(mats * fi * fo + fo for fi, fo in zip(dims[:-1], dims[1:]))
    nbytes = (2 * v * dims[0] + 9 * e + 4 * v * dims[-1] + 2 * 2 * n_params + 4
              + (2 * 3 * 4 * n_params if opt == "adam" else 0))
    fwd = sum(mats * 2 * v * fi * fo for fi, fo in zip(dims[:-1], dims[1:]))
    inputs = sum(mats * 2 * v * fi * fo for fi, fo in zip(dims[1:-1], dims[2:]))
    fwd_type = "bfloat16" if family == "sage" else "float32"
    ops = {fwd_type: fwd * (2 if remat else 1)}
    ops["float32"] = ops.get("float32", 0) + fwd + inputs
    ops_s = sum(n / PEAK_OPS_PER_S[t] for t, n in ops.items())
    bytes_s = nbytes / HBM_BYTES_PER_S
    return {"bytes": nbytes, "ops": ops, "bound_ms": max(bytes_s, ops_s) * 1e3,
            "bound_by": "bytes" if bytes_s >= ops_s else "operations"}


def _train_inputs(torch, device="cuda"):
    """Phase 4's stream over its 4 windows as one edge list, config #5's
    feature table, and f32 targets from ``TR_TARGET_SEED``."""
    src, dst = make_stream(N_VERTICES, WINDOW * N_WINDOWS, seed=STREAM_SEED)
    _, table = _sage_params(torch)
    targets = torch.randn((N_VERTICES, DIMS[-1]),
                          generator=torch.Generator().manual_seed(TR_TARGET_SEED))
    return (table.table.to(device), torch.from_numpy(src).to(device),
            torch.from_numpy(dst).to(device),
            torch.ones(src.shape[0], dtype=torch.bool, device=device), targets.to(device))


def _train_params(torch, family, device="cuda"):
    from gelly_streaming_tpu_torch.models import init_gcn

    if family == "sage":
        return [{k: v.to(device) for k, v in layer.items()} for layer in _sage_params(torch)[0]]
    return init_gcn(DIMS, torch.bfloat16, generator=torch.Generator().manual_seed(0),
                    device=device)


def _train_step_fn(torch, family, opt, remat=False, mesh=None):
    from gelly_streaming_tpu_torch.models import gcn_forward, make_gnn_train_step, sage_forward

    return make_gnn_train_step(
        mesh, sage_forward if family == "sage" else gcn_forward, lr=TR_LR[family],
        optimizer=(lambda ps: torch.optim.Adam(ps, lr=TR_ADAM_LR)) if opt == "adam" else None,
        remat=remat)


def _flat_params(torch, params):
    return torch.cat([v.float().flatten() for layer in params for _, v in sorted(layer.items())])


def _train_steps(torch, family, opt, inputs, steps, remat=False, mesh=None):
    """``steps`` steps of ``family`` from its seeded parameters: the losses
    (read after the last step) and the whole parameters (gathered under a
    model axis) flattened after each step."""
    from gelly_streaming_tpu_torch.models import gather_gnn_params

    step, shard, init_opt = _train_step_fn(torch, family, opt, remat, mesh)
    params = shard(_train_params(torch, family))
    state = init_opt(params)
    losses, flats = [], []
    for _ in range(steps):
        params, state, loss = step(params, state, *inputs)
        losses.append(loss)
        flats.append(_flat_params(torch, gather_gnn_params(params, mesh)))
    return [x.item() for x in losses], flats


def _step_breakdown(torch, family, inputs):
    """Device ms of the parts of one SGD step, each run alone between CUDA
    events (``cuda_ms``): every layer whole and its dense part (the kernel,
    or GCN's f32 product), whose difference is the layer's message passing
    (gathers and scatters), the forward without autograd, and the whole
    step; the backward and the update are the step less the forward."""
    from gelly_streaming_tpu_torch.models import gcn_forward, gcn_layer, sage_forward, sage_layer
    from gelly_streaming_tpu_torch.models.graphsage import mean_aggregate
    from gelly_streaming_tpu_torch.ops.sage_kernels import fused_sage_matmul

    h, s, d, m, t = inputs
    params = _train_params(torch, family)
    step, _, _ = _train_step_fn(torch, family, "sgd")
    out = {"layers": []}
    with torch.no_grad():
        x = h
        for i, p in enumerate(params):
            act = "relu" if i < len(params) - 1 else "none"
            if family == "sage":
                agg = mean_aggregate(x, s, d, m, x.shape[0])
                layer = functools.partial(sage_layer, p, x, s, d, m, activation=act)
                dense = functools.partial(fused_sage_matmul, x, agg, p["w_self"], p["w_nbr"],
                                          p["b"], act)
            else:
                layer = functools.partial(gcn_layer, p, x, s, d, m, activation=act)
                dense = functools.partial(lambda a, w: a.float() @ w.float(), x, p["w"])
            row = {"layer_ms": cuda_ms(torch, layer, iters=5, warmup=1),
                   "dense_ms": cuda_ms(torch, dense, iters=5, warmup=1)}
            row["message_passing_ms"] = row["layer_ms"] - row["dense_ms"]
            out["layers"].append(row)
            x = layer()
        fwd = sage_forward if family == "sage" else gcn_forward
        out["forward_ms"] = cuda_ms(torch, lambda: fwd(params, h, s, d, m), iters=5, warmup=1)
    out["step_ms"] = cuda_ms(torch, lambda: step(params, None, *inputs), iters=5, warmup=1)
    out["backward_and_update_ms"] = out["step_ms"] - out["forward_ms"]
    return out


def _time_steps(torch, family, opt, remat, inputs):
    """ms a step on the host clock (a warm step first, ``TR_TIMED`` steps
    ended by a synchronize) and the peak device memory of those steps."""
    step, shard, init_opt = _train_step_fn(torch, family, opt, remat)
    params = shard(_train_params(torch, family))
    state = init_opt(params)
    params, state, _ = step(params, state, *inputs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    for _ in range(TR_TIMED):
        params, state, _ = step(params, state, *inputs)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / TR_TIMED * 1e3
    return {"ms_per_step": ms, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "resident_gb": resident / 1e9}


def _first_grads(torch, family, inputs, device="cuda", plain=False):
    """The loss's gradients at the seeded parameters: through the port's
    forward, or (``plain``) through a forward composed of ``mean_aggregate``
    and ``fused_sage_matmul_plain``."""
    from gelly_streaming_tpu_torch.models import gcn_forward, mse_loss, sage_forward
    from gelly_streaming_tpu_torch.models.graphsage import mean_aggregate
    from gelly_streaming_tpu_torch.ops.sage_kernels import fused_sage_matmul_plain

    h, s, d, m, t = inputs
    leaves = [{k: v.detach().requires_grad_() for k, v in layer.items()}
              for layer in _train_params(torch, family, device)]
    if plain:
        out = h
        for i, p in enumerate(leaves):
            agg = mean_aggregate(out, s, d, m, out.shape[0])
            out = fused_sage_matmul_plain(out, agg, p["w_self"], p["w_nbr"], p["b"],
                                          "relu" if i < len(leaves) - 1 else "none")
    else:
        out = (sage_forward if family == "sage" else gcn_forward)(leaves, h, s, d, m)
    flat = [v for layer in leaves for _, v in sorted(layer.items())]
    return torch.autograd.grad(mse_loss(out, t), flat)


def _grad_errors(got, want):
    """(max abs error, max |reference|) of each gradient."""
    return [((a.float().cpu() - b.float().cpu()).abs().max().item(),
             b.float().abs().max().item()) for a, b in zip(got, want)]


def _train_family(torch, family, smi, inputs):
    """(a) or (b): the eight-step runs under deterministic algorithms (the
    counts set to 0 just before), the first step's gradients, then the
    timed steps without deterministic algorithms."""
    from gelly_streaming_tpu_torch.ops import sage_kernels as sk

    tag = f"train ({'a' if family == 'sage' else 'b'}) {family} [{smi}]"
    out = {"runs": {}, "timed": {}}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            sk.LAUNCHES = 0
            sk.LAUNCHES_BY_VARIANT.update(tc=0, simt=0)
            for opt in ("sgd", "adam"):
                for remat in (False, True):
                    before = dict(sk.LAUNCHES_BY_VARIANT)
                    losses, flats = _train_steps(torch, family, opt, inputs, TR_STEPS, remat)
                    launched = {k: sk.LAUNCHES_BY_VARIANT[k] - before[k] for k in before}
                    out["runs"][(opt, remat)] = {"losses": losses, "flats": flats,
                                                 "launches": launched}
            torch.cuda.synchronize()
            out["launches"] = dict(sk.LAUNCHES_BY_VARIANT)
            if family == "sage":
                got = _first_grads(torch, family, inputs)
                want = _first_grads(torch, family, inputs, plain=True)
            else:
                got = _first_grads(torch, family, inputs)
                want = _first_grads(torch, family, tuple(x.cpu() for x in inputs), device="cpu")
        determinism = sorted({str(w.message)[:120] for w in caught
                              if "determinis" in str(w.message)})
    finally:
        torch.use_deterministic_algorithms(False)
    for msg in determinism:
        say(f"{tag}: warning under deterministic algorithms: {msg}")
    for (opt, remat), run in out["runs"].items():
        per_step = 4 if remat else 2
        want_launch = ({"tc": per_step * TR_STEPS, "simt": 0} if family == "sage"
                       else {"tc": 0, "simt": 0})
        descends = run["losses"][-1] < run["losses"][0]
        say(f"{tag} {opt} remat={remat}: losses {[round(x, 5) for x in run['losses']]}, "
            f"fused_sage_matmul launches {run['launches']} (expected {want_launch}), "
            f"{'descends' if descends else 'FAIL: no descent'}")
        if not descends or run["launches"] != want_launch:
            raise AssertionError(f"{tag} {opt} remat={remat}: no descent or wrong launches")
    for opt in ("sgd", "adam"):
        same = all(torch.equal(a, b) for a, b in zip(out["runs"][(opt, False)]["flats"],
                                                      out["runs"][(opt, True)]["flats"]))
        say(f"{tag} {opt}: remat changes no parameter over {TR_STEPS} steps: "
            f"{'bit for bit' if same else 'FAIL'}")
        if not same:
            raise AssertionError(f"{tag} {opt}: remat changed the parameters")
    errs = _grad_errors(got, want)
    ref_name = "autograd through fused_sage_matmul_plain on the card" if family == "sage"         else "the same step's gradients on the CPU"
    worst = max(e / max(r, 1e-30) for e, r in errs)
    say(f"{tag}: first-step gradients against {ref_name}: max_abs_err/max|ref| per "
        f"tensor {[f'{e:.3e}/{r:.3e}' for e, r in errs]}, worst {worst:.3e} (tol {TR_GRAD_TOL})")
    if not worst <= TR_GRAD_TOL:
        raise AssertionError(f"{tag}: the card's gradients disagree with {ref_name}")
    out["grad_err"] = worst
    for opt in ("sgd", "adam"):
        for remat in (False, True):
            row = _time_steps(torch, family, opt, remat, inputs)
            row.update(train_step_bytes(N_VERTICES, WINDOW * N_WINDOWS, DIMS, family, opt,
                                        remat))
            row["bound_share"] = row["bound_ms"] / row["ms_per_step"]
            out["timed"][(opt, remat)] = row
            say(f"{tag} {opt} remat={remat} [{smi}]: " + json.dumps(row))
    out["breakdown"] = _step_breakdown(torch, family, inputs)
    say(f"{tag}: where an SGD step's device time goes (ms between CUDA events, warm) [{smi}]: "
        + json.dumps(out["breakdown"]))
    return out


def _collective_host_ms(prof):
    """Host ms of the collectives in a profile (the c10d and gloo ranges),
    by name."""
    return {e.key: e.cpu_time_total / 1e3 for e in prof.key_averages()
            if "c10d" in e.key or "gloo" in e.key}


def _train_rank(rank, world, init, work):
    """One rank of the (c) world: gloo, every rank's tensors on card 0; the
    SGD and Adam steps on each mesh of ``TR_MESHES`` that holds this rank
    (a mesh of n ranks takes ranks 0 to n - 1; every rank builds every
    mesh), under deterministic algorithms; pickles the gathered
    parameters, the losses and the collectives it issued. Rank 0 profiles
    one more SGD step on the 2x2 mesh; then every rank runs
    ``dryrun_multichip`` (d)."""
    import pickle

    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from gelly_streaming_tpu_torch.graft_entry import dryrun_multichip
    from gelly_streaming_tpu_torch.parallel import comm, make_mesh, multihost

    multihost.initialize(init, world, rank, device="cuda:0", backend="gloo",
                         timeout_s=MESH_TIMEOUT_S)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    inputs = _train_inputs(torch)
    out = {}
    for shape in TR_MESHES:
        n = shape[0] * shape[1]
        mesh = make_mesh(*shape, devices=range(n), device="cuda")
        if rank >= n:
            continue
        comm.reset_counters()
        t0 = time.perf_counter()
        runs = {opt: _train_steps(torch, "sage", opt, inputs, TR_MESH_STEPS, mesh=mesh)
                for opt in ("sgd", "adam")}
        out[shape] = {
            "runs": {opt: (losses, flats[-1].cpu().numpy()) for opt, (losses, flats) in runs.items()},
            "seconds": time.perf_counter() - t0, "calls": dict(comm.CALLS),
            "staged": dict(comm.STAGED)}
        if shape == (2, 2):
            step, shard, _ = _train_step_fn(torch, "sage", "sgd", mesh=mesh)
            params = shard(_train_params(torch, "sage"))
            step(params, None, *inputs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                step(params, None, *inputs)
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if rank == 0:
                say(f"train (c) gloo mesh 2x2 rank 0: one SGD step profiled, {wall * 1e3:.1f} ms")
                profile_pass(torch, None, wall, prof)
                say("train (c) gloo mesh 2x2 rank 0: collectives' host ms in that step "
                    + json.dumps(_collective_host_ms(prof)))
    # (d) runs PageRank, whose fixpoint kernel refuses deterministic
    # algorithms: they cover the training steps above only
    torch.use_deterministic_algorithms(False)
    t0 = time.perf_counter()
    dryrun_multichip(world, device="cuda")
    out["dryrun_s"] = time.perf_counter() - t0
    with open(os.path.join(work, f"train-rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def phase_train(torch, smi):
    """Slice 3 on the card: (a) GraphSAGE and (b) GCN training at config
    #5's width, (c) the sharded step on meshes over the one card, (d)
    ``entry()`` and ``dryrun_multichip(4)``."""
    import pickle
    import tempfile

    import torch.distributed as dist
    import torch.multiprocessing as mp

    from gelly_streaming_tpu_torch.graft_entry import entry
    from gelly_streaming_tpu_torch.parallel import comm, make_mesh, multihost

    inputs = _train_inputs(torch)
    sage = _train_family(torch, "sage", smi, inputs)
    gcn = _train_family(torch, "gcn", smi, inputs)

    # (c) the width-1 reference: (a)'s runs after TR_MESH_STEPS steps
    base = {opt: (sage["runs"][(opt, False)]["losses"][:TR_MESH_STEPS],
                  sage["runs"][(opt, False)]["flats"][TR_MESH_STEPS - 1].cpu().numpy())
            for opt in ("sgd", "adam")}
    # an NCCL world of one: make_mesh(1, 1) is the single-device step
    multihost.initialize(device="cuda", timeout_s=MESH_TIMEOUT_S)
    mesh = make_mesh(1, 1, device="cuda")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            comm.reset_counters()
            one = {opt: _train_steps(torch, "sage", opt, inputs, TR_MESH_STEPS, mesh=mesh)
                   for opt in ("sgd", "adam")}
    finally:
        torch.use_deterministic_algorithms(False)
    same = all(np.array_equal(one[opt][1][-1].cpu().numpy(), base[opt][1])
               and one[opt][0] == base[opt][0] for opt in one)
    say(f"train (c) {dist.get_backend()} width 1, mesh 1x1 [{smi}]: SGD and Adam "
        f"{TR_MESH_STEPS} steps each, collectives {dict(comm.CALLS)}, "
        f"{'bit for bit equal' if same else 'FAIL'} to (a)'s width-1 run")
    dist.destroy_process_group()
    if not same:
        raise AssertionError("the 1x1 mesh's step differs from the single-device step")
    del one
    mesh_rows = {}
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        init = "file://" + os.path.join(work, "train-store")
        mp.start_processes(_train_rank, args=(TR_WORLD, init, work), nprocs=TR_WORLD,
                           join=True, start_method="spawn")
        ranks = []
        for r in range(TR_WORLD):
            with open(os.path.join(work, f"train-rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
        say(f"train (c) gloo world of {TR_WORLD} on the one card: "
            f"{time.perf_counter() - t0:.1f} s")
        for shape in TR_MESHES:
            tag = f"train (c) gloo mesh {shape[0]}x{shape[1]} [{smi}]"
            r0 = ranks[0][shape]
            for r, res in enumerate(ranks[1:shape[0] * shape[1]], 1):
                for opt in ("sgd", "adam"):
                    (la, pa), (lb, pb) = res[shape]["runs"][opt], r0["runs"][opt]
                    if la != lb or not np.array_equal(pa, pb):
                        raise AssertionError(f"{tag}: rank {r} differs from rank 0 ({opt})")
            row = {"seconds": r0["seconds"], "calls": r0["calls"], "staged": r0["staged"]}
            for opt in ("sgd", "adam"):
                (losses, flat), (bl, bflat) = r0["runs"][opt], base[opt]
                p_err = float(np.abs(flat - bflat).max())
                p_ref = float(np.abs(bflat).max())
                l_err = max(abs(a - b) / abs(b) for a, b in zip(losses, bl))
                p_tol = TR_MESH_TOL * p_ref + (
                    2 * TR_ADAM_LR * TR_MESH_STEPS if opt == "adam" else 0.0)
                row[opt] = {"losses": losses, "param_err": p_err, "param_tol": p_tol,
                            "param_ref": p_ref, "loss_rel_err": l_err}
                if not (p_err <= p_tol and l_err <= TR_MESH_TOL):
                    raise AssertionError(f"{tag} {opt}: {p_err:.3e} of {p_ref:.3e} from "
                                         f"the width-1 run (losses {l_err:.3e})")
            say(f"{tag}: every rank bit-equal; against width 1 (tol {TR_MESH_TOL}): "
                + json.dumps(row))
            mesh_rows[shape] = row
        say(f"train (d) dryrun_multichip({TR_WORLD}) on the gloo world of {TR_WORLD} on "
            f"the card: every section's asserts held on every rank "
            f"({ranks[0]['dryrun_s']:.1f} s)")

    # (d) entry() on the card against the CPU
    fn, args = entry()
    got = fn(*args)
    cpu_fn, cpu_args = entry(device="cpu")
    want = cpu_fn(*cpu_args)
    err = (got.float().cpu() - want.float()).abs().max().item()
    ref = want.float().abs().max().item()
    ok = (tuple(got.shape) == (256, 64) and bool(torch.isfinite(got.float()).all())
          and err <= SLICE_TOL * ref)
    say(f"train (d) entry() on the card: shape {tuple(got.shape)} {got.dtype}, against "
        f"entry(device='cpu') max_abs_err {err:.3e} of max|ref| {ref:.3e} "
        f"(tol {SLICE_TOL * ref:.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("entry() on the card disagrees with the CPU")
    return {"launches": sage["launches"]["tc"], "sage": sage["timed"], "gcn": gcn["timed"],
            "mesh": mesh_rows}


def timed(name, fn, *args):
    """Run one phase and print its wall seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    say(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    return out


def main():
    import torch

    t_start = time.perf_counter()
    smi = timed("device", phase_device, torch)
    timed("build", phase_build)
    main_err, rows = timed("kernels", phase_kernels, torch)
    slice_result = timed("slice", phase_slice, torch, rows)
    sa_result = timed("sage aggregate", phase_sage_aggregate, torch, smi)
    _, cc_oracle = timed("cc", phase_cc, torch)
    timed("northstar", phase_northstar, torch, smi)
    timed("degrees", phase_degrees, torch)
    timed("triangles", phase_triangles, torch)
    timed("neighborhood", phase_neighborhood, torch)
    pagerank_result = timed("pagerank", phase_pagerank, torch, smi)
    timed("bipartiteness", phase_bipartiteness, torch)
    timed("exact triangles", phase_exact_triangles, torch)
    spanner_result = timed("spanner", phase_spanner, torch, smi)
    de_result = timed("device-encode", phase_device_encode, torch)
    fold_row = timed("cc fold", phase_cc_fold, torch, smi)
    sampling_result = timed("sampling", phase_sampling, torch)
    icc_result = timed("iterative cc", phase_iterative_cc, torch)
    timed("durability", phase_durability, torch, cc_oracle)
    timed("autok", phase_autok, torch)
    timed("eventtime", phase_eventtime, torch)
    timed("ingest", phase_ingest, torch)
    timed("serving", phase_serving, torch, cc_oracle)
    timed("routing", phase_routing, torch)
    mesh_result = timed("mesh", phase_mesh, torch)
    train_result = timed("train", phase_train, torch, smi)
    say(f"all phases: {time.perf_counter() - t_start:.1f} s")
    kernel = {
        "name": "fused_sage_matmul",
        "variant": "tc",
        "route": "cuda",
        "source": "gelly_streaming_tpu_torch/csrc/fused_sage_matmul.cu",
        "replaces": "gelly_streaming_tpu/ops/pallas_kernels.py:51",
        "launches": slice_result["launches"],
        "launches_mesh": mesh_result["launches"],
        "launches_train": train_result["launches"],
        "max_abs_err": main_err,
        "ms": sum(r["kernel_ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": sum(r["bound_ms"] for r in rows),
        "bound_by": "bytes",
        "library_ms": sum(r["library_ms"] for r in rows),
        "bound_share": sum(r["bound_ms"] for r in rows) / sum(r["kernel_ms"] for r in rows),
        "warm_ms": sum(r["warm"]["kernel_ms"] for r in rows),
        "per": f"window: {rows[0]['shape']} + {rows[1]['shape']}, bf16, cold L2",
        "status": "ported",
    }
    k3 = spanner_result["k3_eps"]
    row = k3["kernel_row"]
    k_reach = {
        "name": "k_reach_search",
        "route": "cuda",
        "source": "gelly_streaming_tpu_torch/csrc/k_reach.cu",
        "replaces": "gelly_streaming_tpu/library/spanner.py:103",
        "replaces_kind": "an XLA step (_k_reach_cnt), not a Pallas kernel",
        "launches": k3["launches"],
        "max_abs_err": 0.0,
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        # no single PyTorch call ORs int32 words by segment
        "library_ms": None,
        "device_bitmap_ms": row["device_bitmap_ms"],
        "bound_share": row["bound_share"],
        "frontier_bound_ms": row["frontier_bound_ms"],
        "frontier_bound_share": row["frontier_bound_share"],
        "active_bound_ms": row["active_bound_ms"],
        "active_bound_share": row["active_bound_share"],
        "per": row["per"],
        "status": "ported",
    }
    rows = (pagerank_result["kernel_row"], pagerank_result["kernel_row_scale"])

    # config #4's last window's figures, then the scale pass's last window's
    # under "scale"
    keys = ("max_abs_err", "ms", "setup_ms", "first_iteration_ms", "ms_an_iteration",
            "bound_ms", "bound_by", "bound_share", "iteration_bound_ms",
            "iteration_bound_share", "iterations", "ms_turns")
    pagerank_fixpoint = {
        "name": "pagerank_fixpoint",
        "route": "cuda",
        "source": "gelly_streaming_tpu_torch/csrc/pagerank.cu",
        "replaces": "gelly_streaming_tpu/library/pagerank.py:89",
        "replaces_kind": "an XLA step (the fixpoint of _make_pr_window_body), not a "
                         "Pallas kernel",
        "launches": rows[0]["launches"],
        "plain_ms": rows[0]["plain_ms"],
        # one iteration of torch.mv on a sparse CSR matrix of the carry, times
        # the kernel's iterations: no single PyTorch call computes the fixpoint
        "library_ms": rows[0]["library_ms"],
    }
    pagerank_fixpoint.update({k: rows[0][k] for k in keys})
    pagerank_fixpoint["scale"] = {k: rows[1][k] for k in keys}
    pagerank_fixpoint["scale"].update(plain_ms=rows[1]["plain_ms"],
                                      library_ms=rows[1]["library_ms"],
                                      in_degrees=rows[1]["in_degrees"], per=rows[1]["per"])
    pagerank_fixpoint.update(in_degrees=rows[0]["in_degrees"], per=rows[0]["per"],
                             status="ported")
    scan = sampling_result["scan_full"]["kernel_row"]
    reservoir_scan = {
        "name": "reservoir_scan",
        "route": "cuda",
        "source": "gelly_streaming_tpu_torch/csrc/reservoir_scan.cu",
        "replaces": "gelly_streaming_tpu/library/sampling.py:50",
        "replaces_kind": "an XLA step (lax.scan), not a Pallas kernel",
        "launches": scan["launches"],
        "max_abs_err": scan["max_abs_err"],
        "ms": scan["ms"],
        "plain_ms": scan["plain_ms"],
        "bound_ms": scan["bound_ms"],
        "bound_by": scan["bound_by"],
        # no PyTorch call folds a reservoir over an edge sequence
        "library_ms": None,
        "draws_ms": scan["draws_ms"],
        "coins_read_ms": scan["coins_read_ms"],
        "bound_share": scan["bound_share"],
        "bound_ms_edge_by_edge_rule": scan["bound_ms_edge_by_edge_rule"],
        "bound_share_edge_by_edge_rule": scan["bound_share_edge_by_edge_rule"],
        "design": "one cooperative launch a draw batch: the coin matrix read in parallel "
                  "for each sample's last replacement, then its closing pairs after it",
        "ms_turns": scan["ms_turns"],
        "per": f"{scan['per']}; {smi}",
        "status": "ported",
    }
    cc_fold_window = {
        "name": "cc_fold_window",
        "route": "cuda",
        "source": "gelly_streaming_tpu_torch/csrc/cc_fold.cu",
        "replaces": "gelly_streaming_tpu/summaries/labels.py: label_combine(state, "
                    "cc_fold(init_labels(V), ...))",
        "replaces_kind": "an XLA step (two lax.while_loop fixpoints), not a Pallas kernel",
        # the kernel phase's direct calls, then the main path's: the
        # device-encoded CC passes and the iterative CC's diff pass
        "launches": fold_row["launches"],
        "launches_per_window_device_encode": {
            form: de_result[form]["cc_fold_launches_per_window"] for form in de_result},
        "launches_per_window_iterative_cc": icc_result["cc_fold_launches_per_window"],
        "max_abs_err": 0.0 if all(fold_row["equal_to_plain"]) else None,
        "ms": fold_row["ms_mean"],
        "ms_median": fold_row["ms_median"],
        "cold_ms": fold_row["cold_ms"],
        "plain_ms": fold_row["plain_device_ms_mean"],
        "bound_ms": fold_row["bound_ms"],
        "bound_by": fold_row["bound_by"],
        # no PyTorch call folds edges into a union-find
        "library_ms": None,
        "bound_share": fold_row["bound_share_mean"],
        "reverse_path_ms": fold_row["reverse_path_ms"],
        "design": "one cooperative launch a window: copy the carried table, a lock-free "
                  "union-find over the window's lanes, then a compress pass",
        "per": f"{fold_row['per']}; {smi}",
        "status": "ported",
    }
    sage_segment_mean = {
        "name": "sage_segment_mean",
        "route": "cuda",
        "source": "gelly_streaming_tpu_torch/csrc/sage_aggregate.cu",
        "replaces": "gelly_streaming_tpu/models/graphsage.py:53 mean_aggregate",
        "replaces_kind": "an XLA gather and scatter-add, not a Pallas kernel",
        # the config #5 slice's launches: one a layer on the main path
        "launches": slice_result["mean_launches"],
        "launches_per_window": slice_result["mean_launches"] / N_WINDOWS,
        "ms": sa_result["ms_window"],
        "plain_ms": sa_result["plain_ms_window"],
        "bound_ms": sa_result["bound_ms_window"],
        "bound_by": "bytes",
        # the edge-list composition the kernel replaces on the main path
        "library_ms": sa_result["library_ms_window"],
        "csr_append_ms": sa_result["append_ms_last"],
        "design": "one cooperative launch a layer: a merge-path split of rows and messages "
                  "over the grid, float32 sums in registers, partial rows fixed up in order",
        "per": sa_result["per"],
        "status": "ported",
    }
    sage_segment_mean["bound_share"] = sage_segment_mean["bound_ms"] / sage_segment_mean["ms"]
    say(json.dumps({"kernels": [kernel, k_reach, pagerank_fixpoint,
                                reservoir_scan, cc_fold_window, sage_segment_mean]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
