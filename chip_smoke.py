"""Drive the PyTorch port's settlement and consensus paths on one CUDA card
and check them.

    python3 chip_smoke.py

Phases, one JSON line each (``script_s``: the script's seconds when the
line was printed):

1. ``device``       the card (``nvidia-smi`` name and power limit).
2. ``build``        compile the four kernel sources from the package's
                    ``.cu`` files, one ``nvcc`` each, started together; fail
                    if ptxas reports a spill in any kernel, or a stack frame
                    in any instantiation but the two wide stack-tree ones
                    (``onepass_settle`` and ``onepass_partials`` beyond 64
                    slots), or if the log lacks an entry function of any of
                    them (``settle_cycles.cu`` also holds the replay lanes'
                    ``settle_cycles_lanes`` kernel).
3. ``kernel_check`` ``settle_cycles`` against its plain torch version on
                    the card, float32 and float64, K in {1, 5, 15, 16, 40,
                    65, 200}, a ragged M, steps in {0, 1, 2, 20}, with pads,
                    cold slots, empty markets and stamps later than
                    ``now``, and a ragged tile (K = 200: one market with
                    every slot among markets with one) that overflows the
                    shared stage and takes the wide route: state and
                    ``rel_touched`` bit-equal, consensus within tolerance.
                    Each launch reports its tiles by route: they must
                    cover the markets, the ragged tile must take the wide
                    route, and both routes must have run.
4. ``onepass_check`` ``onepass_settle`` against its plain version on the
                    card: float32 with every combination of the tie-break
                    and bands stages, float64 with the tie-break off; K in
                    {1, 5, 16, 17, 33, 40, 64, 65} (band trees of depth 0
                    to 6 in registers and the wider stack), M = 1037,
                    steps in {0, 1, 2, 20}, with
                    cold slots, empty markets, all-tied markets and stamps
                    on and off multiples of the half-life: state, tie-break
                    and band moments bit-equal, consensus within tolerance.
5. ``bp_check``     ``bp_sweep`` against its plain version on the card:
                    M = 1037, D in {1, 2, 8, 33}, the point lane with
                    either blend contraction and the moments lane, fixed
                    depth and early exits after 1, 5 or 6 sweeps or none,
                    ``max_steps`` in {1, 2, 24}, with edgeless rows, NaN
                    seeds, zero variances and a row whose mix is NaN: mean,
                    variance, ``iters_run`` and ``residual`` bit-equal, and
                    one launch a call.
6. ``partials_check`` ``onepass_partials`` against its plain version on
                    the card: float32 and float64, every combination of the
                    views and bands stages, K_loc in {1, 2, 3, 4, 5, 8, 16,
                    17, 33, 64, 65} (band trees of depth 0 to 6 in
                    registers and the wider stack),
                    M = 1037, steps in {0, 1, 2, 20}, with pad slots (mask
                    false, the cold prior), cold slots, empty markets and
                    stamps on and off multiples of the half-life: state,
                    views, band roots and count bit-equal (a NaN as a NaN),
                    raw consensus sums within tolerance; each launch must
                    report the band-tree depth its K_loc calls for.
7. ``native``       build the port's C extensions (``fastpack``,
                    ``internmap``) from the package's sources with the
                    system ``cc``: whether they built, the build seconds,
                    the compiler, ``Python.h``, ``libsqlite3`` (the C
                    SQLite writer's runtime) and, if the Python twins ran,
                    the reason the build module recorded. A failing build
                    with a compiler and ``Python.h`` present fails the run.
8. ``main_path``    1,000,000 markets, Poisson(3)+1 signals each from a
                    10,000-source universe (seed 7), through
                    ``build_settlement_plan_columnar`` on a CUDA store (the
                    default host route: the C grouping pass, interner and
                    SQLite writer when they built, ``intern_mode="auto"``),
                    two chained 20-step ``settle`` calls, the consensus
                    fetch, ``store.sync()`` and ``flush_to_sqlite``. The
                    kernel launch count must rise by exactly one per settle,
                    each settle's consensus must match the plain version on
                    the inputs that settle was given, the first settle's
                    state must be bit-equal to the plain version's, and the
                    flush must write every row.
9. ``host_routes``  the main path's first 250,000 markets (a cut: the
                    Python route's full-width pass took ~45 s) through the
                    default C route and the Python route (``native=False``
                    under ``BCE_NO_NATIVE=1``: the dict interner, the numpy
                    grouping, the sqlite3 module), each on a fresh store
                    through the same two settles, sync and flush, timed
                    like the main path: the plans' ``slot_rows`` and the
                    consensus equal, and the two checkpoints'
                    ``SELECT * FROM sources ORDER BY source_id, market_id``
                    of equal sha256; then both routes on a 50,000-market
                    cut, their ``iterdump()`` equal (the CREATE statement's
                    whitespace normalised: the C writer's schema text is
                    one line).
10. ``delta_check`` on the main path's first 250,000 markets (a cut: at
                    full width its two 4M-row checkpoints took most of the
                    phase), a
                    second batch drifting from that cut (10% of
                    markets replaced, 5% of the rest given new signals, the
                    order shuffled) bound with ``intern_mode="auto"`` and
                    ``"full"`` on twin stores that bound the cut's
                    batch first: equal rows, equal checkpoint sha256 after
                    a 2-step settle of each plan, the delta route's
                    ``matched_pairs`` above 0, and a re-bind of the same
                    batch that hits the pair fingerprint.
11. ``analytics_path`` the main path's plan and store (1M markets) through a
                    resident ``ShardedSettlementSession``: two chained
                    20-step ``settle_with_analytics`` calls with the default
                    ``AnalyticsOptions``, then ``close`` (which syncs the
                    store). The one-pass kernel's launch count must rise by
                    exactly one per call, and each call's outputs must match
                    the plain version on that call's inputs (state, tie-break
                    and band moments bit-equal, consensus within tolerance).
                    Then, on three fresh stores of 20,000 markets: flat
                    ``settle``, session ``settle`` and session
                    ``settle_with_analytics`` must leave byte-equal SQLite
                    files and bit-equal consensus.
12. ``inference_path`` the same plan and store through a session with a
                    real graph, made from the seed: 250,000 mutually
                    exclusive events of 4 consecutive markets
                    (``MarketBlocks``) and 2 correlation edges per market to
                    random markets of other events, weights U(0.5, 1.5):
                    D = 5, 5M edges, passed as ``blocks.to_graph(
                    extra_edges=...)`` with ``blocks=`` and
                    ``InferenceOptions(tol=1e-5, max_steps=24)``. Two
                    chained 20-step ``settle_with_analytics`` calls: the
                    ``bp_sweep`` launch count must rise by exactly
                    ``launches_per_call(max_steps)`` (one) per call, each
                    call's sweep must be
                    bit-equal to the plain version on that call's seeds and
                    its projection to ``MarketBlocks.project`` of it, every
                    event's projected means must sum to 1 within 1e-6, and
                    the second call must reuse the aligned neighbour blocks.
                    Then, on two fresh stores of 20,000 markets, the session
                    with a graph and without one must leave byte-equal
                    SQLite files.
13. ``sharded_path`` the main path's plan and store (1M markets) through a
                    session on a (1, 4) mesh of the one card
                    (``make_mesh((1, 4), [cuda:0] * 4)``: K padded to a
                    multiple of 4, K_loc slots a shard): two chained 20-step
                    ``settle_with_analytics`` calls with the default
                    ``AnalyticsOptions``, then ``close``. The partials
                    kernel's launch count must rise by exactly 4 per call
                    (no other kernel launches); each launch's outputs must
                    match the plain version on that shard's inputs; each
                    call's state must be bit-equal to one ``onepass_settle``
                    launch on the same inputs unsharded, its bands too (the
                    shard boundaries fall on subtree boundaries when K_loc
                    is a power of two), its consensus within tolerance. Then,
                    on fresh stores of 20,000 markets, the one-card session
                    and sessions on (1, 2), (1, 4) and (2, 2) meshes must
                    leave byte-equal SQLite files, and one (1, 4) call with
                    the inference path's graph must run ``bp_sweep`` on the
                    merged consensus (bit-equal to its plain version).
14. ``kernels``     each kernel's launches on its path, error, time (CUDA
                    events over 21 back-to-back launches after warm-up, each
                    on fresh input copies, issued while the stream waits on
                    the card so that host time between launches is not
                    counted; a kernel window the host still paced fails),
                    plain-version time (``plain_paced_by`` says whether the
                    device or the host set its pace) and
                    byte bound: ``settle_cycles`` on the chained flat
                    settle's inputs (every row exists: the steady state),
                    under ``one_step_ms`` the same launch at ``steps=1``,
                    under ``stage_slots``, ``tiles`` and ``wide_tiles`` the
                    kernel's own route report of that launch, and, under ``cold``, on the first settle's (no row
                    exists yet); ``onepass_settle`` on the chained analytics
                    call's inputs, and under ``stages_off_ms``,
                    ``tiebreak_only_ms`` and ``bands_only_ms`` the same
                    launch with both analytics stages off or one of them
                    on; ``bp_sweep``
                    on the chained inference call's seeds (its time per
                    call of one cooperative launch, the bound for the
                    sweeps that ran); ``onepass_partials`` on the sharded
                    path's chained call (``ms`` one call's 4 launches, also
                    per launch; ``stages_off_ms`` the same launches with the
                    views and bands off; ``merge_ms`` the eager cross-shard
                    merge, with ``merge_paced_by``). Every entry also carries ptxas' registers, stack
                    frame and spills from the build log (for
                    ``settle_cycles`` both dtypes, for the one-pass and
                    partials kernels the instantiation the path's K or
                    K_loc takes, with its ``band_tree_depth``, which the
                    partials kernel reports itself);
                    ``bp_sweep`` and the two one-pass kernels also
                    ``launches_per_call``; ``settle_cycles`` also
                    ``journal_launches``, its launches in phase 16's delta
                    step, ``settle_cycles`` and ``onepass_settle``
                    ``stream_launches``, theirs in phase 17, and
                    ``serve_launches``, theirs in phase 18 (``settle_cycles``:
                    the two seeding settles and the CLI's serve;
                    ``onepass_settle``: acts A and B and A's re-drive);
                    ``onepass_partials`` also ``analytics_rest_launches``,
                    its launches in phase 19, and ``settle_cycles``
                    ``replay_launches``, lane 0's in phase 20, and
                    ``bp_sweep`` ``shards_launches``, its launches on phase
                    21's markets-sharded sessions and banded sweeps;
                    ``onepass_settle`` and ``onepass_partials``
                    ``cluster_launches``, their launches in phase 22's rank
                    processes. A fifth entry, ``settle_cycles_lanes``, comes
                    from phase 20. The line is printed after phase 22.
15. ``batch_consensus`` the consensus surface, which runs none of the four
                    kernels: the main path's 1,000,000 markets as object
                    payloads (``{"sourceId", "probability"}`` dicts) with a
                    per-source table from the seed (reliability and
                    confidence U(0, 1), 10% of sources absent: cold start,
                    5% present with an empty entry), through one
                    ``pack_markets`` on the C route with ``mapping_lookup``,
                    then ``run_packed`` (the ordered segment sums of
                    ``ops/consensus.py``) on the card and on the CPU at
                    float32 and float64: all four outputs bit-equal card
                    against CPU, each ordered sum's rounds equal to its
                    longest segment. ``compute_batch_consensus`` on the card
                    at float64 over the first 100,000 markets (a cut: its
                    host formatting of 1M documents alone takes tens of
                    seconds): every document equal to the one formatted from
                    the 1M-market pass, and 2,000 sampled ones within
                    rel 1e-12 of the scalar ``compute_consensus``. The
                    golden fixture through ``compute_consensus(backend=
                    "torch", device="cuda", dtype=torch.float64)`` and the
                    scalar path, byte for byte; the three ``sim_*`` fixtures
                    well-formed, deterministic, within rel 1e-12 of the
                    scalar path and in their scenario's range. Then
                    ``MarketStore.compute_all_consensus(store,
                    backend="torch")`` (device CUDA by default, float64) over
                    10,000 markets, over a SQLite store and a card tensor
                    store given the same updates, against the scalar sweep
                    within rel 1e-6 (decay is read at other instants), no
                    cold-start sources. Prints host seconds per stage, the
                    rounds, the pass's peak device bytes above what the
                    earlier phases hold, and the
                    ``nvidia-smi`` line.
16. ``journal``     the journal tier and the background flushes on the main
                    store (every row settled by phases 8 and 11-13): a
                    ``JournalWriter`` on a fresh file and a full-snapshot
                    epoch of every row (``flush_to_journal``, tag 0); a plan
                    over the first 100,000 markets, one 20-step ``settle``
                    (exactly one ``settle_cycles`` launch), then
                    ``flush_to_journal_async`` (tag 1: the touched rows
                    only) and ``flush_to_sqlite_async`` to the main path's
                    file (incremental: every row dirtied since its flush)
                    together; ``replay_journal(device="cuda")`` while the
                    SQLite write runs, equal to the live store (reliability,
                    confidence, stamps, existence, ISO stamps and row
                    assignment) at tag 1; the replayed store's
                    ``flush_to_sqlite_async`` to a fresh file, whose rows
                    must equal the incremental file's, every one (equal
                    counts, and a join on the primary key inside SQLite
                    finds no row missing or different).
                    Then on a store of 1,037 markets settled three times,
                    journaled twice and traced three times: a torn tail
                    replays to tag 0, a resumed writer appends after it
                    (tag 5, replaying to the resumed store), compaction
                    keeps state and tag and shrinks the file, and
                    ``extract_trace`` returns the two batches the journal
                    covers (``strict=True`` refuses the third). Prints the
                    seconds of each step (the async calls' blocking time and
                    each ``result()``'s wait), the epochs' rows and bytes,
                    and the registry's ``journal.*`` and
                    ``interchange.delta_rows`` counters.
17. ``stream``      the streamed, resident settlement service at the main
                    path's width: four columnar batches of the main
                    path's markets (string source ids, as the trace
                    records them), ``steps=20``, one day apart —
                    B0 the main path's data, B1 its topology with the
                    probabilities redrawn, B2 the drifting batch (as
                    ``delta_check`` makes it), B3 B2's topology redrawn —
                    through ``settle_stream(reuse_plans=True, columnar=
                    True, journal=...)`` twice, each on a fresh card
                    store: A flat (``settle_cycles``); R on the (1, 1) mesh
                    of the card (``onepass_settle``), with a SQLite tail
                    flush and a trace, under a recording timeline, an
                    enabled registry and a tracer. R's trace and its
                    store's ``store_digest`` go to phase 20, whose lane 0
                    re-drives the trace (this phase's own ``drive_trace``
                    re-drive, D, was cut for time). Each stream's prefetch
                    worker takes batch k only after batch k-1 was yielded
                    (an ungated worker interns ahead of the epochs, and
                    the journal bytes would depend on thread timing).
                    R's ``session_adopt`` must be ``["start", "refresh",
                    "relayout", "refresh"]``, ``plan_reused`` ``[False,
                    True, False, True]``, ``stream.resident_fallbacks`` 0
                    and ``stream.session_adopts`` 1; A must launch
                    ``settle_cycles`` 4 times and R ``onepass_settle`` 4
                    times (no other settle kernel); A's and R's stores
                    (reliability, confidence, stamps, existence, row
                    assignment) must be bit-equal, their journals
                    byte-equal with each
                    epoch's ``wall_unix_ts`` (and the CRC over it) masked,
                    each batch's consensus within tolerance, and R's tail
                    flush must write every existing row. Prints each run's
                    seconds (and the seconds after its last yield), R's
                    per-batch ``plan_wait_s``, ``settle_dispatch_s``,
                    ``checkpoint_s``, ``intern_s``, ``interned_pairs`` and
                    ``phases``, the phases after its last yield, the
                    stream counters, ``hbm.bytes_in_use`` and
                    ``hbm.peak_bytes``, the adopt's entering rows, and R's
                    journal, trace and SQLite bytes. The ``kernels`` line
                    (printed after this phase) carries the stream's
                    launches of ``settle_cycles`` and ``onepass_settle``
                    as ``stream_launches``.

18. ``serve``       the request front door at the main path's width, over
                    a card store seeded by one flat 20-step ``settle`` of the
                    main path's whole batch (~4M rows; one ``settle_cycles``
                    launch). A request is one market's update and outcome:
                    the market's main-path sources, fresh probabilities and
                    a fair outcome (seed 23), 80% of requests on the hottest
                    tenth of the markets. Act A: ``ConsensusService`` on the
                    card's (1, 1) mesh (``steps=20``, a journal epoch every
                    batch, ``max_batch=4096``, ``max_delay_s=0.005``,
                    ``analytics=True``, ``record_batches=True``) behind a
                    ``ConsensusServer`` on 127.0.0.1 with 4 acceptors; 16
                    client threads of a load-generator process, started
                    before the store is seeded, each send 1,024 requests
                    in ``submit_pipelined`` chunks of 256 (16,384 in all),
                    under an enabled registry and a tracer. Every answer
                    must be a result (no refusal, ``net.wire_errors`` 0),
                    one ``onepass_settle`` launch a batch; the batch log
                    re-driven in lockstep through ``drive_trace`` on the
                    same mesh and a second store seeded the same way must
                    give a bit-equal store, a journal byte-equal with the
                    wall clock masked, and every request's consensus bit
                    for bit. Prints requests/s, p50/p99 of
                    ``serve.latency_total_s``, batches and their fill,
                    plan-cache hits and misses (consecutive topology
                    fingerprints), session adopts, ``ingest_wait_s``, the
                    batches' phase spans (sum and max), ``hbm.*`` and the
                    launches. Act B, on act A's store: two classes,
                    ``premium`` (``reject``, budget 64, sized to its 8
                    closed-loop clients) and ``besteffort``
                    (``shed_oldest``, budget 64), the shed ranking seeded
                    with act A's band standard errors; 8 premium clients
                    submit one request at a time while one best-effort
                    client pipelines an 8,192-request burst (in chunks of
                    256: a client that sends the whole burst before reading
                    deadlocks against the server's answers). Premium must
                    refuse nothing, best effort must shed or reject, no
                    class's pending count may pass its budget, and at least
                    one shed victim's market must have had a band (the
                    variance-aware ranking ran); prints each class's
                    goodput. Act C: the CLI's ``serve --port 0 --duration
                    8 --journal ... --qos premium:1.0:8192`` in a
                    subprocess on the default device (``cuda``; the CLI
                    module run as ``-m`` runs it, reporting its
                    ``settle_cycles`` launches at exit), 8,192 requests from
                    4 clients: the summary must show ``requests ==
                    responses == 8192``, batches, no wire error and one
                    launch a batch; then ``journal-export`` of its journal
                    to a fresh DB and ``list-sources --market-id`` of a
                    served market, through the CLI's ``main()`` in this
                    process, must exit 0 and list its sources.
19. ``analytics_rest`` the main path's data on two fresh card stores,
                    each through a session on the card's (1, 1) mesh: two
                    20-step ``settle_with_analytics`` calls (the second's
                    reads decay 10 days), one with the ring tie-break
                    (``onepass_settle``), one with ``tiebreak="sorted"``
                    (one ``onepass_partials`` launch a call, its read views
                    through the eager ``batched_tiebreak``). The sorted
                    session's state must be bit-equal to the ring
                    session's after each call (its consensus within
                    tolerance; whether bit-equal is printed); the card's
                    sorted tie-break bit-equal to its plain run on the CPU
                    on the same views; and, before the ring session's
                    second call, ``build_band_program`` on the session's
                    block, state and read day (one zero-step partials
                    launch) must leave the state bit-equal and give the
                    bands that call returns, bit for bit. Prints the
                    launches, the sorted tie-break's eager stage time and
                    the band program's (CUDA events over a window,
                    ``paced_by`` as in phase 14) and host seconds.
20. ``replay``      ``replay_sweep`` over phase 17's trace (four 1M-market
                    batches, 20 steps) with 16 configs, the JAX bench's
                    grid (``bench.py:4310-4318``): one ``settle_cycles``
                    (lane 0's flat re-drive) and one ``settle_cycles_lanes``
                    launch a batch; lane 0's ``store_digest`` must equal
                    R's; every lane settles the same markets, the lanes'
                    metrics are finite and their band widths move with z;
                    a second sweep with ``rebuild=False`` gives the same
                    lane metrics and lane-state bytes; ``replay_single`` of
                    an altered lane equals its sweep lane (settled markets,
                    sums within rel 1e-6). Every lane launch of the three
                    runs passes a six-slot route report, and ``group_share``
                    lists per launch the share of its (tile, lane) pairs
                    that a block settled for a group of lanes through one
                    read of the plan (tiles whose markets lie in row
                    order). ``settle_cycles_lanes`` on the first and the
                    last batch's 16 lanes at their full 1M markets must be
                    bit-equal to its plain version (state and consensus;
                    ``max_abs_err`` is the measured largest difference),
                    then is timed on the last batch in place
                    (every masked row exists after a warm-up launch: the
                    steady state) with its plain version and byte bound;
                    ``lane_scaling`` times the launch at C in {1, 4, 16,
                    64} lanes (the captured lanes' first C, or the 16
                    repeated), each with its time a lane and byte bound
                    (C = 1, lane 0 alone, is also ``one_lane_ms``), and
                    ``lane_scaling_first_batch`` the same on the first
                    batch, whose rows the store interned in its markets'
                    order; ``settle_cycles_lane0_ms`` times the main path's
                    ``settle_cycles`` on lane 0's captured state and plan
                    (what the replay plan's rows cost apart from the lane
                    instantiation); ``stage_slots``, ``shared_bytes`` and
                    ``group_lanes`` are the 16-lane launch's own report.
                    Prints per batch the host seconds of the plan, lane 0's
                    dispatch, the lane launch and the whole step, each
                    closed by a synchronise, and each lane's means.

21. ``shards``     the one-process multi-shard tier on the card. (a) The
                    main path's batch on three fresh card stores, with phase
                    12's graph (``InferenceOptions(tol=1e-5, max_steps=
                    24)``, no block projection), through the one-card
                    session and sessions on ``make_mesh((4, 1), [cuda] *
                    4)`` and ``(2, 2)``: two chained 20-step
                    ``settle_with_analytics`` calls each; ``bp_sweep``'s
                    launch count must rise by exactly one a call, each
                    call's sweep must be bit-equal to one whole-axis launch
                    on its seeds and blocks and the session's means and
                    stderrs to that launch's; the (4, 1) session's seeds,
                    means and stderrs must be the one-card session's, bit
                    for bit (whether the (2, 2) session's seeds are is
                    printed). Then, on fresh 20,000-market stores with the
                    graph and its blocks, the one-card session and sessions
                    on (2, 1), (4, 1) and (2, 2) must leave byte-equal
                    SQLite files. (b) The one-card session's second sweep
                    (seeds and aligned blocks at 1M markets) through
                    ``infer/partition.py``: ``partition_csr`` into 4 and 16
                    contiguous bands and ``banded_bp_sweep``, whose means,
                    variances, ``iters_run`` and residual must be bit-equal
                    to the whole-axis launch's and whose launches must be
                    bands x iterations; prints ``cross_edges``, the halo
                    rows, the host seconds of the partition and of the
                    sweep, and the kernel ms (each band's one-step launch
                    timed in a queued window, summed over the iterations).
                    (c) The JAX bench's large-K shape (``bench.py:133-135``:
                    16,384 markets x 10,000 slots, 50 steps, data made on
                    the card from the seed, cold state, day 1): the port's
                    flat cycle loop (``build_cycle_loop``, the one-pass
                    kernel), its plain cycle math, and the ring loop on
                    (1, 1) and (1, 4) meshes; every state bit-equal to the
                    kernel loop's, the ring consensus within rtol 2e-6,
                    atol 1e-6 of the plain loop's (the sums' order differs;
                    its distance from the kernel's, which adds the slots in
                    order, is printed). (d) The compact loop at the same
                    shape: its decoded state within rtol 1e-6, atol 1e-6 of
                    the flat loop's (stamps and existence bit-equal), its
                    consensus within that of the plain loop's,
                    ``advance_counters`` equal to its counters, and the
                    loop on uint16 probabilities bit-equal to the loop on
                    their decode; then one timed compact run at the
                    north-star band (``bench.py:137-145``: 125,056 x
                    10,000, 40 steps) and the float32 state through the
                    flat loop there. Prints cycles per second for every
                    loop and the peak device bytes above the inputs of the
                    compact and float32 runs.
22. ``cluster``    the multi-process cluster tier on the card. (a) Two rank
                    processes on the one card, joined by
                    ``init_distributed`` over gloo on 127.0.0.1 (a free
                    port, a 120 s rendezvous timeout; no tensor crosses a
                    process), each making the main path's batch from the
                    seed and, per rank, a drifted successor of its own
                    markets (``band_drift``: ``drifted_batch`` over the
                    band, so no market changes band). Per ici shape (1, 1)
                    and (1, 2) of ``make_hybrid_mesh`` (one granule a
                    rank), each rank builds its band's plan only
                    (``MeshView.band``, the globally agreed K), runs two
                    chained 20-step ``settle`` calls of a band session,
                    adopts the drifted band plan (``"relayout"`` by the
                    host-staged route, its block bit-equal to a session
                    rebuilt from the synced host, all four fields) and
                    settles it once; ``onepass_settle`` must launch 3 times
                    a rank on (1, 1), ``onepass_partials`` 6 on (1, 2).
                    Meanwhile this process runs the same calls on the whole
                    axis through the one-card session and a (1, 2) mesh
                    session: the ranks' consensus of every call and the
                    stored values at both plans' slots must be those
                    sessions', bit for bit, and the ranks' stores hold
                    their rows. Prints each rank's rendezvous, plan, settle,
                    adopt and rebuild-check seconds and peak device bytes.
                    (b) The kill soak, ``python -m
                    bayesian_consensus_engine_tpu_torch.cluster.soak
                    --hosts 2 --markets 250000 --batches 12 --kill-after 3
                    --json`` (the host routes' cut; workers on the card):
                    exit 0 with its byte coda holding; prints the recovered
                    goodput, adoption and coda seconds and rows adopted.
23. ``surface``    the rest of the public surface at the main path's width
                    (its 1M-market (K, M) block, K = 15, with a warm state
                    from the seed: cold slots and stamps 1, 10 and 30 days
                    old). (a) ``build_cycle`` market-major and slot-major,
                    with ``donate=True`` and ``False``: one
                    ``onepass_partials`` launch a call, the state bit-equal
                    to the plain cycle math on the card, consensus,
                    confidence and total weight within tolerance; with
                    ``donate=False`` the caller's state unchanged, with
                    ``donate=True`` (slot-major) settled in place.
                    (b) ``build_cycle_loop(slot_major=False,
                    donate=False)`` for 20 steps against the plain one-pass
                    version. (c) ``build_cycle_tiebreak_loop`` on the
                    card's (1, 1) mesh against the plain one-pass version
                    (tie-break bit-equal), and on a (1, 2) mesh of the card
                    (K padded to 16) against the same loop with the plain
                    partials, its state also the (1, 1) loop's. (d) The
                    20-step loop resumed from a ``CycleCheckpointer``
                    snapshot after 10 steps (restored with ``like=`` onto
                    the card) bit-equal to the straight run; prints the
                    save's synchronous and commit seconds, the restore
                    seconds and the bytes on disk. (e) The slot-major loop
                    under ``auto_trace(every_n=3)`` for 6 calls: exactly
                    two Chrome traces, each holding ``bce.onepass_settle``;
                    where they hold device events (CUPTI), one
                    ``onepass_settle`` kernel each, and the traced window's
                    device busy share and the kernel's device ms are
                    printed (``device_events`` 0 otherwise). (f) On the
                    host routes' cut, a child process (this script with
                    ``--surface-child``, started at the phase's start, at
                    most 300 s) settles two days through the flat C route,
                    calls ``save_checkpoint`` with the settled state still
                    deferred on the card and is killed with ``SIGKILL``;
                    this process loads the snapshot onto the card, rebuilds
                    the plan (the same rows) and settles the third day:
                    its consensus bit-equal and its SQLite bytes equal to
                    an uninterrupted chain's. Launches: ``settle_cycles``
                    4, ``onepass_settle`` 10, ``onepass_partials`` 6 (the
                    ``kernels`` line's ``surface_launches``).

Then the ``nvidia-smi`` line, and last ``{"ok": true, "device": ...}``.
Any failure exits non-zero without that line; so does a machine without
CUDA and a directory without the package.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import shutil
import sqlite3
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM device-memory rate (NVIDIA data sheet), for the byte bound.
HBM_BYTES_PER_S = 3.35e12
NOW = 20000.25  # epoch-days
MARKETS, MEAN_SIGNALS, SOURCES, SEED, STEPS = 1_000_000, 4, 10_000, 7, 20
PARITY_MARKETS = 20_000
# The host routes' full iterdump() comparison, and the delta check's drift:
# a tenth of the markets replaced, a twentieth of the rest redrawn.
DUMP_MARKETS, REPLACED, REDRAWN = 50_000, 0.10, 0.05
# The two host routes side by side, a quarter of the main path's markets;
# the delta check binds its two batches on the same cut.
HOST_ROUTE_MARKETS = 250_000
DELTA_MARKETS = HOST_ROUTE_MARKETS
# The inference path's graph and sweep.
EVENT_SIZE, CORRELATIONS, BP_TOL, BP_MAX_STEPS = 4, 2, 1e-5, 24
# partials_check's K_loc, each with the band-tree depth of the kernel
# instantiation that must settle it: log2(pow2_at_least(K_loc)) up to 64,
# the stack tree (-1) beyond.
PARTIALS_DEPTHS = {1: 0, 2: 1, 3: 2, 4: 2, 5: 3, 8: 3, 16: 4, 17: 5, 33: 6,
                   64: 6, 65: -1}
# Consensus tolerance (exp2 and the K-sum order differ); state is bit-equal.
TOL = {np.dtype(np.float32): dict(rtol=1e-5, atol=1e-6),
       np.dtype(np.float64): dict(rtol=1e-12, atol=0.0)}


SCRIPT_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One phase's JSON line, with the script's seconds so far."""
    print(json.dumps({"phase": phase, **fields,
                      "script_s": time.perf_counter() - SCRIPT_START}),
          flush=True)


def table_digest(path) -> str:
    """sha256 of ``SELECT * FROM sources ORDER BY source_id, market_id``
    (each row's repr: floats exactly)."""
    digest = hashlib.sha256()
    with contextlib.closing(sqlite3.connect(path)) as conn:
        cursor = conn.execute(
            "SELECT * FROM sources ORDER BY source_id, market_id")
        while rows := cursor.fetchmany(1 << 16):
            digest.update(repr(rows).encode())
    return digest.hexdigest()


def table_mismatches(path, other) -> "tuple[int, int, int]":
    """Both checkpoints' row counts and the rows of *path* that *other*
    lacks or holds with another value, in one join on the primary key
    inside SQLite. With equal counts and unique keys, no mismatch means
    the two tables hold the same rows."""
    with contextlib.closing(sqlite3.connect(path)) as conn:
        conn.execute("ATTACH DATABASE ? AS other", (str(other),))
        counts = conn.execute(
            "SELECT (SELECT COUNT(*) FROM main.sources), "
            "(SELECT COUNT(*) FROM other.sources)").fetchone()
        mismatched = conn.execute(
            "SELECT COUNT(*) FROM main.sources a LEFT JOIN other.sources b "
            "ON a.source_id = b.source_id AND a.market_id = b.market_id "
            "WHERE b.reliability IS NOT a.reliability "
            "OR b.confidence IS NOT a.confidence "
            "OR b.updated_at IS NOT a.updated_at").fetchone()[0]
    return counts[0], counts[1], mismatched


def dump_lines(path) -> list:
    """``iterdump()`` of a checkpoint with the CREATE statements'
    whitespace normalised: the C writer's schema text is one line, the
    sqlite3 module's several (the same columns, types and keys)."""
    with contextlib.closing(sqlite3.connect(path)) as conn:
        return [" ".join(line.split()) if line.startswith("CREATE") else line
                for line in conn.iterdump()]


def segment_index(starts, lengths):
    """Flat indices of the segments [starts[i], starts[i] + lengths[i])."""
    ends = np.cumsum(lengths)
    return np.repeat(starts - (ends - lengths), lengths) + np.arange(
        int(ends[-1]) if len(ends) else 0)


def drifted_batch(rng, market_keys, counts, codes):
    """The next batch of a drifting stream: REPLACED of the markets
    replaced by new ones, REDRAWN of the rest given new signals, every
    other market's sources kept (new probabilities), and the market order
    shuffled. Returns ``(keys, codes, probs, offsets)``."""
    num_markets = len(market_keys)
    replaced = np.zeros(num_markets, dtype=bool)
    replaced[rng.choice(num_markets, int(num_markets * REPLACED),
                        replace=False)] = True
    rest = np.flatnonzero(~replaced)
    fresh = replaced.copy()
    fresh[rng.choice(rest, int(len(rest) * REDRAWN), replace=False)] = True
    new_counts = np.where(fresh, rng.poisson(MEAN_SIGNALS - 1, num_markets) + 1,
                          counts)
    new_offsets = np.concatenate([[0], np.cumsum(new_counts)])
    new_codes = np.empty(int(new_offsets[-1]), dtype=codes.dtype)
    kept = np.repeat(~fresh, new_counts)
    starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
    new_codes[kept] = codes[segment_index(starts[~fresh], counts[~fresh])]
    new_codes[~kept] = rng.integers(0, SOURCES, int((~kept).sum()))
    perm = rng.permutation(num_markets)
    order = segment_index(new_offsets[:-1][perm], new_counts[perm])
    keys = [f"market-new-{m}" if replaced[m] else market_keys[m]
            for m in perm.tolist()]
    out_codes = new_codes[order]
    return (keys, out_codes, rng.random(len(out_codes)),
            np.concatenate([[0], np.cumsum(new_counts[perm])]))


def check_equal(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    got, want = got.cpu().numpy(), want.cpu().numpy()
    if got.dtype != want.dtype or not np.array_equal(got, want):
        bad = int(np.sum(got != want)) if got.shape == want.shape else -1
        raise AssertionError(f"{what}: not bit-equal ({bad} elements differ)")


def check_consensus(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    got, want = got.cpu().numpy(), want.cpu().numpy()
    if not np.array_equal(np.isnan(got), np.isnan(want)):
        raise AssertionError(f"{what}: NaN positions differ")
    np.testing.assert_allclose(
        got, want, equal_nan=True, err_msg=what, **TOL[got.dtype]
    )
    finite = ~np.isnan(got)
    return float(np.max(np.abs(got[finite] - want[finite]), initial=0.0))


def random_case(rng, num_slots, num_markets, np_dtype, ragged=False):
    """A plan block over a flat state: distinct shuffled rows per masked
    slot, pads (row -1), empty markets, cold rows, stale and future stamps.
    ``ragged``: market 7 has every slot and every other market slot 0 only,
    so the first tile overflows the stage sized for the mean."""
    shape = (num_slots, num_markets)
    if ragged:
        mask = np.zeros(shape, dtype=bool)
        mask[0] = True
        mask[:, 7] = True
    else:
        mask = rng.random(shape) < 0.7
    mask[:, :: 17] = False  # empty markets
    num_touched = int(mask.sum())
    capacity = num_touched + 101
    rows = np.full(shape, -1, dtype=np.int32)
    rows[mask] = rng.permutation(capacity)[:num_touched]
    return dict(
        rel=rng.uniform(0.0, 1.0, capacity).astype(np_dtype),
        conf=rng.uniform(0.0, 1.0, capacity).astype(np_dtype),
        # 0 = never stamped; 512.5 lies after now0 (a backdated settle).
        days=rng.choice([0.0, 3.0, 35.0, 499.5, 512.5], capacity).astype(np_dtype),
        exists=rng.random(capacity) < 0.6,
        rows=rows,
        probs=rng.random(shape).astype(np_dtype),
        mask=mask,
        outcome=rng.random(num_markets) < 0.5,
        now0=500.0,
    )


def block_case(rng, num_slots, num_markets, np_dtype, now0):
    """A resident (K, M) block: pads, empty markets, all-tied markets
    (every slot one tie-break group), cold slots, and stamps on and off
    multiples of the 30-day half-life (one after now0)."""
    shape = (num_slots, num_markets)
    mask = rng.random(shape) < 0.7
    mask[:, :: 17] = False
    probs = rng.random(shape)
    tied = np.arange(num_markets) % 13 == 5
    probs[:, tied] = 0.625
    mask[:, tied] = True
    stamps = [0.0, now0, now0 - 30.0, now0 - 90.0, 3.0, 35.0, now0 + 12.5]
    return dict(
        probs=probs.astype(np_dtype), mask=mask,
        outcome=rng.random(num_markets) < 0.5,
        rel=rng.uniform(0.0, 1.0, shape).astype(np_dtype),
        conf=rng.uniform(0.0, 1.0, shape).astype(np_dtype),
        days=rng.choice(stamps, shape).astype(np_dtype),
        exists=rng.random(shape) < 0.6,
    )


def clone_outputs(out):
    """A copy of a one-pass call's outputs (the kernel updates the state in
    place, so a later call would overwrite them)."""
    def copy(x):
        return None if x is None else x.clone()

    return type(out)(
        type(out.state)(*(x.clone() for x in out.state)),
        out.consensus.clone(),
        None if out.tiebreak is None else type(out.tiebreak)(
            *(x.clone() for x in out.tiebreak)),
        copy(out.band_sums), copy(out.band_count),
    )


def compare_onepass(got, want, what):
    """Kernel outputs against the plain version's: state, tie-break and
    band moments bit-equal, consensus within TOL; returns the largest
    absolute difference over the float outputs."""
    for field, a, b in zip(want.state._fields, got.state, want.state):
        check_equal(a, b, f"{what} {field}")
    err = check_consensus(got.consensus, want.consensus, f"{what} consensus")
    if want.tiebreak is not None:
        for field, a, b in zip(want.tiebreak._fields, got.tiebreak, want.tiebreak):
            check_equal(a, b, f"{what} {field}")
    if want.band_sums is not None:
        check_equal(got.band_sums, want.band_sums, f"{what} band sums")
        check_equal(got.band_count, want.band_count, f"{what} band count")
    return err


def partials_case(rng, num_slots, num_markets, np_dtype, now0):
    """One sources shard's (K_loc, M) block: pad slots (mask false, the
    cold prior), empty markets, cold slots, and stamps on and off multiples
    of the 30-day half-life (one after now0)."""
    shape = (num_slots, num_markets)
    mask = rng.random(shape) < 0.7
    mask[:, ::17] = False
    exists = rng.random(shape) < 0.6
    rel = rng.uniform(0.0, 1.0, shape)
    conf = rng.uniform(0.0, 1.0, shape)
    stamps = [0.0, now0, now0 - 30.0, now0 - 90.0, 3.0, 35.0, now0 + 12.5]
    days = rng.choice(stamps, shape)
    if num_slots > 2:
        pad = slice(num_slots - 2, None)
        mask[pad], exists[pad], rel[pad], conf[pad], days[pad] = (
            False, False, 0.5, 0.25, 0.0)
    return dict(
        probs=rng.random(shape).astype(np_dtype), mask=mask,
        outcome=rng.random(num_markets) < 0.5, rel=rel.astype(np_dtype),
        conf=conf.astype(np_dtype), days=days.astype(np_dtype), exists=exists,
    )


def compare_partials(got, want, what):
    """Partials kernel outputs against the plain version's: state, views,
    band roots and count bit-equal (a NaN as a NaN), the raw consensus sums
    within TOL; returns their largest absolute difference."""
    for field, a, b in zip(want.state._fields, got.state, want.state):
        check_bits(a, b, f"{what} {field}")
    for field in ("band_sums", "band_count", "read_rel", "read_conf"):
        a, b = getattr(got, field), getattr(want, field)
        if (a is None) != (b is None):
            raise AssertionError(f"{what} {field}: present in one only")
        if b is not None:
            check_bits(a, b, f"{what} {field}")
    a, b = got.consensus_sums.cpu().numpy(), want.consensus_sums.cpu().numpy()
    np.testing.assert_allclose(a, b, err_msg=f"{what} raw sums", **TOL[a.dtype])
    return float(np.max(np.abs(a - b), initial=0.0))


def kernel_args(case, dtype, steps, settle_kernel):
    touched_rows, offsets = settle_kernel.touched_layout(case["rows"], case["mask"])
    cuda = torch.device("cuda")

    def t(x, dt=None):
        return torch.tensor(x, dtype=dt, device=cuda)

    return (
        t(case["rel"], dtype), t(case["conf"], dtype), t(case["days"], dtype),
        t(case["exists"]), t(case["rows"]), t(case["probs"], dtype),
        t(case["mask"]), t(case["outcome"]), t(offsets), len(touched_rows),
        float(np.dtype(case["rel"].dtype).type(case["now0"])), steps,
    )


def compare_kernel(args, settle_kernel, what, routes=None):
    """Run the plain version and the kernel (on clones) on the same inputs;
    ``routes`` receives the kernel's route report."""
    want = settle_kernel.settle_cycles_reference(*args)
    clones = [a.clone() if isinstance(a, torch.Tensor) else a for a in args]
    got = settle_kernel.settle_cycles(*clones, routes=routes)
    torch.cuda.synchronize()
    for field in ("reliability", "confidence", "updated_days", "exists",
                  "rel_touched"):
        check_equal(getattr(got, field), getattr(want, field), f"{what} {field}")
    return check_consensus(got.consensus, want.consensus, f"{what} consensus")


# Device clock cycles the stream first waits before a timed window: ~25 ms
# on an H100, longer than the host takes to issue a kernel's window.
QUEUE_CYCLES = 50_000_000


def time_window(fn, prepare, warmup: int, runs: int):
    """``(ms, paced_by)``: milliseconds per call of ``fn`` by CUDA events
    over ``runs`` calls launched back to back, each on its own fresh inputs
    from ``prepare`` (made beforehand, outside the timed window), after
    ``warmup`` calls. The stream first waits on the card while the host
    issues the whole window, so the calls run back to back on the device
    even where the host's per-call work takes longer than a kernel.
    ``paced_by`` is "device" when the host had issued the window before
    the wait ran out (the figure is the device's time per call). If it had
    not, the window is timed once more behind a wait sized from the host's
    issue time; if the host still comes last (a function that synchronises
    inside, or eager work slower than its kernels), ``paced_by`` is "host"
    and the figure is the host's pace."""
    for _ in range(warmup):
        fn(prepare())
    cycles = QUEUE_CYCLES
    for _attempt in range(2):
        inputs = [prepare() for _ in range(runs)]
        waited = torch.cuda.Event(enable_timing=True)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        waited.record()
        torch.cuda._sleep(cycles)
        start.record()
        issue = time.perf_counter()
        for args in inputs:
            fn(args)
        issue_ms = (time.perf_counter() - issue) * 1e3
        end.record()
        in_time = not start.query()  # the wait still held the stream
        end.synchronize()
        ms = start.elapsed_time(end) / runs
        if in_time:
            return ms, "device"
        wait_ms = waited.elapsed_time(start)
        cycles = int(cycles * max(2.0, 2.0 * issue_ms / max(wait_ms, 1e-3)))
    return ms, "host"


def time_cuda(fn, prepare, warmup: int, runs: int) -> float:
    """A kernel's device time per call (:func:`time_window`); raises if
    the host, not the device, set the pace of the window."""
    ms, paced_by = time_window(fn, prepare, warmup, runs)
    if paced_by != "device":
        raise AssertionError(
            "a kernel's timed window was paced by the host, not the device")
    return ms


def bp_case(rng, num_markets, degree):
    """Seeds and neighbour blocks: pads, edgeless rows, NaN seeds, zero
    variances and, with D = 33, a row whose mix is NaN (infinite weights)."""
    idx = rng.integers(0, num_markets, (num_markets, degree)).astype(np.int32)
    idx[rng.random(idx.shape) < 0.2] = -1
    idx[::11] = -1
    weights = rng.uniform(0.5, 1.5, idx.shape).astype(np.float32)
    means = rng.random(num_markets).astype(np.float32)
    variances = (rng.random(num_markets) * 0.01).astype(np.float32)
    means[rng.random(num_markets) < 0.05] = np.nan
    variances[rng.random(num_markets) < 0.1] = 0.0
    if degree == 33:
        idx[7] = np.arange(degree) + 20
        weights[7] = np.inf
    return means, variances, idx, weights


def check_bits(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    """Bit-equal tensors, a NaN comparing as NaN whatever its payload."""
    got, want = got.cpu().numpy(), want.cpu().numpy()
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{what}: dtype or shape differs")
    if want.dtype.kind != "f":
        if not np.array_equal(got, want):
            raise AssertionError(f"{what}: not equal")
        return
    nan = np.isnan(want)
    bits = np.uint32 if want.dtype == np.float32 else np.uint64
    if not (np.array_equal(np.isnan(got), nan)
            and np.array_equal(got[~nan].view(bits), want[~nan].view(bits))):
        raise AssertionError(f"{what}: not bit-equal")


def compare_sweep(got, want, what):
    """A bp_sweep result against the plain version's: all four bit-equal."""
    for field, a, b in zip(("mean", "var", "iters_run", "residual"), got, want):
        if b is None:
            if a is not None:
                raise AssertionError(f"{what} {field}: expected None")
        elif field == "iters_run":
            if a.dtype != torch.int32 or int(a) != int(b):
                raise AssertionError(f"{what}: iters_run {int(a)} != {int(b)}")
        else:
            check_bits(a, b, f"{what} {field}")


def inference_graph(keys, seed, blocks_module):
    """The inference path's graph over *keys*: mutually exclusive events of
    EVENT_SIZE consecutive markets, and CORRELATIONS edges per market to
    random markets of other events, weights U(0.5, 1.5)."""
    num = len(keys)
    rng = np.random.default_rng(seed)
    blocks = blocks_module.MarketBlocks([
        blocks_module.MarketBlock(
            "mutually_exclusive", tuple(keys[e: e + EVENT_SIZE]))
        for e in range(0, num, EVENT_SIZE)
    ])
    src = np.repeat(np.arange(num), CORRELATIONS)
    other_event = rng.integers(1, num // EVENT_SIZE, src.size)
    dst = (src // EVENT_SIZE * EVENT_SIZE + other_event * EVENT_SIZE
           + rng.integers(0, EVENT_SIZE, src.size)) % num
    weights = rng.uniform(0.5, 1.5, src.size)
    edges = list(zip([keys[i] for i in src.tolist()],
                     [keys[i] for i in dst.tolist()], weights.tolist()))
    return blocks, edges


# batch_consensus: the sampled markets held against the scalar engine, the
# markets of the store sweeps, and the per-source table's shares of sources
# absent (cold start) and present with an empty entry.
SAMPLE_MARKETS, SWEEP_MARKETS, ABSENT, EMPTY_ENTRY = 2_000, 10_000, 0.10, 0.05
# compute_batch_consensus runs over the first DOCUMENT_MARKETS of the
# MARKETS markets (the card-against-CPU check runs over all of them): its
# host formatting of a million documents alone would take tens of seconds.
DOCUMENT_MARKETS = 100_000
# The JAX package's tolerances of the batched path against the scalar one:
# float64 sums (tests/test_batch_parity.py), and the store sweeps, whose
# decay-on-read is taken at slightly different instants.
DOC_RTOL, SWEEP_RTOL = 1e-12, 1e-6
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "fixtures")


def documents_close(got, want, rtol, what):
    """``got`` within *rtol* of ``want`` as ``assert_documents_close`` of
    tests/test_batch_parity.py holds them (``marketId`` aside)."""
    import math

    def close(a, b):
        return math.isclose(a, b, rel_tol=rtol, abs_tol=1e-12)

    problems = []
    for key in ("consensus", "confidence"):
        if (want[key] is None) != (got[key] is None) or (
                want[key] is not None and not close(got[key], want[key])):
            problems.append((key, got[key], want[key]))
    if [w["sourceId"] for w in got["sourceWeights"]] != [
            w["sourceId"] for w in want["sourceWeights"]]:
        problems.append("sourceWeights ids")
    for g, w in zip(got["sourceWeights"], want["sourceWeights"]):
        if not (close(g["weight"], w["weight"])
                and close(g["normalizedWeight"], w["normalizedWeight"])):
            problems.append(("sourceWeights", g, w))
    if not close(got["normalization"]["totalWeight"],
                 want["normalization"]["totalWeight"]) or \
            got["normalization"]["sourceCount"] != \
            want["normalization"]["sourceCount"]:
        problems.append(("normalization", got["normalization"],
                         want["normalization"]))
    if got["diagnostics"] != want["diagnostics"] or \
            got["schemaVersion"] != want["schemaVersion"]:
        problems.append(("diagnostics", got["diagnostics"], want["diagnostics"]))
    if problems:
        raise AssertionError(f"{what}: {problems}")


def batch_consensus_phase(smi, market_keys, codes, probs, offsets):
    """The consensus surface on the card: the main path's markets as object
    payloads through ``pack_markets`` and ``run_packed`` (card against CPU,
    bit for bit, both dtypes), ``compute_batch_consensus`` against the
    scalar engine, the fixtures, and the market store's sweeps."""
    import random

    from bayesian_consensus_engine_tpu_torch import models
    from bayesian_consensus_engine_tpu_torch.core import (
        batch,
        compute_consensus,
        validate_input_payload,
    )
    from bayesian_consensus_engine_tpu_torch.state import SQLiteReliabilityStore
    from bayesian_consensus_engine_tpu_torch.state.tensor_store import (
        TensorReliabilityStore,
    )

    seconds = {}
    start = time.perf_counter()
    names = [f"src-{i}" for i in range(SOURCES)]
    signals = [{"sourceId": names[c], "probability": p}
               for c, p in zip(codes.tolist(), probs.tolist())]
    bounds = offsets.tolist()
    payloads = [(key, signals[bounds[m]:bounds[m + 1]])
                for m, key in enumerate(market_keys)]
    del signals
    # The per-source table, from the seed: reliability and confidence
    # U(0, 1); ABSENT of the sources missing (cold start), EMPTY_ENTRY
    # present with an empty entry (defaults, not cold start).
    table_rng = np.random.default_rng(SEED)
    roll = table_rng.random(SOURCES)
    values = table_rng.random((SOURCES, 2)).tolist()
    table = {}
    for i, name in enumerate(names):
        if roll[i] >= ABSENT + EMPTY_ENTRY:
            table[name] = {"reliability": values[i][0],
                           "confidence": values[i][1]}
        elif roll[i] >= ABSENT:
            table[name] = {}
    lookup = batch.mapping_lookup(table)
    seconds["payloads"] = time.perf_counter() - start

    # 1. One pack on the C route, then the device pass on the card and on
    # the CPU at each dtype: the four outputs bit-equal (a NaN as a NaN).
    start = time.perf_counter()
    packed = batch.pack_markets(payloads, lookup, native=True)
    seconds["pack"] = time.perf_counter() - start
    names_out = ("pair_mean", "total_weight", "weighted_prob", "weighted_conf")
    rounds = {}
    peak = {}
    outputs = {}
    for dtype in (torch.float32, torch.float64):
        label = str(dtype).replace("torch.", "")
        for device in ("cuda", "cpu"):
            # Twice: the first pass of a process also loads the modules of
            # the library kernels it calls.
            for run in ("first", "again"):
                counted = []
                if device == "cuda":
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    held = torch.cuda.memory_allocated()
                start = time.perf_counter()
                out = batch.run_packed(packed, device=device, dtype=dtype,
                                       rounds=counted)
                if device == "cuda":
                    torch.cuda.synchronize()
                    # The pass's own peak, above what earlier phases hold.
                    peak[label] = torch.cuda.max_memory_allocated() - held
                    resident = held
                seconds[f"pass_{device}_{label}_{run}"] = \
                    time.perf_counter() - start
            rounds[f"{device}_{label}"] = dict(zip(("pair_mean",
                                                    "weighted_sums"), counted))
            outputs[device] = out
        for name, got, want in zip(names_out, outputs["cuda"], outputs["cpu"]):
            check_bits(torch.from_numpy(got), torch.from_numpy(want),
                       f"batch_consensus {label} {name}: card against CPU")
        if rounds[f"cuda_{label}"] != rounds[f"cpu_{label}"]:
            raise AssertionError(f"rounds differ: {rounds}")
    longest = {"pair_mean": int(np.bincount(packed.flat_pair).max()),
               "weighted_sums": int(np.diff(packed.pair_offsets).max())}
    if rounds["cuda_float64"] != longest:
        raise AssertionError(f"rounds {rounds['cuda_float64']}, longest "
                             f"segments {longest}")
    # The first DOCUMENT_MARKETS markets' documents from the card's float64
    # sums, as compute_batch_consensus formats them.
    _mean, total_weight, weighted_prob, weighted_conf = outputs["cuda"]
    start = time.perf_counter()
    formatted = [batch._format_document(packed, row, total_weight,
                                        weighted_prob, weighted_conf)
                 for row in range(DOCUMENT_MARKETS)]
    seconds["format"] = time.perf_counter() - start
    num_pairs = packed.num_pairs
    cold_pairs = int((~packed.pair_known).sum())
    del packed, outputs, total_weight, weighted_prob, weighted_conf

    # 2. compute_batch_consensus on the card at float64 over the first
    # DOCUMENT_MARKETS markets (each market's document depends on its own
    # signals alone, so they must equal the ones formatted above); a sample
    # of them against the scalar engine on the same table.
    start = time.perf_counter()
    documents = batch.compute_batch_consensus(
        payloads[:DOCUMENT_MARKETS], lookup, device="cuda", dtype=torch.float64)
    seconds["compute_batch_consensus"] = time.perf_counter() - start
    if len(documents) != DOCUMENT_MARKETS:
        raise AssertionError(f"{len(documents)} documents for "
                             f"{DOCUMENT_MARKETS} markets")
    start = time.perf_counter()
    for row, (market_id, _signals) in enumerate(payloads[:DOCUMENT_MARKETS]):
        document = documents[market_id]
        if document.pop("marketId") != market_id or document != formatted[row]:
            raise AssertionError(f"{market_id}: not the formatted document")
    sample = random.Random(SEED).sample(range(DOCUMENT_MARKETS), SAMPLE_MARKETS)
    for row in sample:
        market_id, market_signals = payloads[row]
        documents_close(documents[market_id],
                        compute_consensus(market_signals, table), DOC_RTOL,
                        f"batched {market_id}")
    seconds["documents_check"] = time.perf_counter() - start
    del documents, formatted

    # 3. The fixtures through the array path on the card at float64 and
    # through the scalar path: the golden one byte for byte, the simulated
    # ones as tests/test_golden_fixtures.py checks them.
    fixtures = {}
    for name in ("golden_regression", "sim_uniform_agreement",
                 "sim_polarized_split", "sim_single_outlier"):
        with open(os.path.join(FIXTURES, f"{name}.json"), encoding="utf-8") as fh:
            fixture = json.load(fh)
        validate_input_payload(fixture["input"])
        fixture_signals = fixture["input"]["signals"]
        card = compute_consensus(fixture_signals, backend="torch",
                                 device="cuda", dtype=torch.float64)
        scalar = compute_consensus(fixture_signals)
        if "expectedOutput" in fixture:
            expected = json.dumps(fixture["expectedOutput"], indent=2)
            for what, document in (("card", card), ("scalar", scalar)):
                if json.dumps(document, indent=2) != expected:
                    raise AssertionError(f"{name}: the {what} document is not "
                                         "the golden bytes")
        if set(card) != {"schemaVersion", "consensus", "confidence",
                         "sourceWeights", "normalization", "diagnostics"} \
                or json.loads(json.dumps(card)) != card \
                or card != compute_consensus(fixture_signals, backend="torch",
                                             device="cuda", dtype=torch.float64):
            raise AssertionError(f"{name}: malformed or not deterministic")
        documents_close(card, scalar, DOC_RTOL, f"fixture {name}")
        fixtures[name] = card["consensus"]
    semantics = {
        "sim_uniform_agreement": 0.78 <= fixtures["sim_uniform_agreement"] <= 0.82,
        "sim_polarized_split": 0.15 < fixtures["sim_polarized_split"] < 0.85,
        "sim_single_outlier": abs(fixtures["sim_single_outlier"]
                                  - (0.60 + 0.62 + 0.58 + 0.61 + 0.05) / 5)
        <= 1e-6 * 0.492,
    }
    if not all(semantics.values()):
        raise AssertionError(f"fixture semantics: {semantics} {fixtures}")

    # 4. The market store's sweep over SWEEP_MARKETS markets with the array
    # backend on the card (device=None), over a SQLite store and a card
    # tensor store given the same updates, against the scalar sweep.
    market_store = models.MarketStore()
    for market_id, market_signals in payloads[:SWEEP_MARKETS]:
        market = market_store.get_or_create(models.MarketId(market_id))
        for signal in market_signals:
            market.add_signal(signal)
    update_rng = random.Random(SEED)
    stores = {"sqlite": SQLiteReliabilityStore(":memory:"),
              "tensor": TensorReliabilityStore()}
    updates = 0
    for market_id, market_signals in payloads[:SWEEP_MARKETS]:
        for signal in market_signals:
            if update_rng.random() < 0.3:
                correct = update_rng.random() < 0.5
                for store in stores.values():
                    store.update_reliability(signal["sourceId"], market_id,
                                             correct)
                updates += 1
    sweeps = {}
    for name, store in stores.items():
        start = time.perf_counter()
        scalar = market_store.compute_all_consensus(store)
        seconds[f"sweep_scalar_{name}"] = time.perf_counter() - start
        start = time.perf_counter()
        swept = market_store.compute_all_consensus(store, backend="torch",
                                                   dtype=torch.float64)
        seconds[f"sweep_torch_{name}"] = time.perf_counter() - start
        if set(swept) != set(scalar) or len(swept) != SWEEP_MARKETS:
            raise AssertionError(f"sweep over {name}: market sets differ")
        for market_id, document in swept.items():
            if document["diagnostics"]["coldStartSources"]:
                raise AssertionError(f"{market_id}: cold-start sources")
            if document.pop("marketId") != scalar[market_id].pop("marketId"):
                raise AssertionError(f"{market_id}: wrong marketId")
            documents_close(document, scalar[market_id], SWEEP_RTOL,
                            f"sweep over {name} {market_id}")
        sweeps[name] = len(swept)
        store.close()

    emit("batch_consensus", markets=len(payloads), signals=int(offsets[-1]),
         pairs=num_pairs, cold_start_pairs=cold_pairs, rounds=rounds,
         peak_device_bytes=peak, resident_device_bytes=resident,
         seconds=seconds,
         sampled_markets=SAMPLE_MARKETS, fixtures=fixtures,
         document_markets=DOCUMENT_MARKETS, sweep_markets=sweeps,
         sweep_updates=updates,
         cut=f"compute_batch_consensus over {DOCUMENT_MARKETS} of "
             f"{len(payloads)} markets",
         nvidia_smi=smi)


# journal: the delta batch (the first JOURNAL_MARKETS markets of the main
# path's data, settled once more at JOURNAL_NOW, after every earlier settle
# of the main store) and the small store of the torn-tail, resume,
# compaction and trace checks (the kernel checks' market count).
JOURNAL_MARKETS, JOURNAL_SMALL_MARKETS = 100_000, 1037
JOURNAL_NOW = NOW + 8 * STEPS


def journal_phase(smi, store, market_keys, codes, probs, offsets, outcomes,
                  main_db, work_dir):
    """The journal tier and the background flushes on the main store: a
    full-snapshot epoch, a settled delta written as an async epoch beside an
    async incremental SQLite flush, replay on the card against the live
    store and its full flush against the incremental file; then torn-tail,
    resume, compaction and trace-sidecar checks on a small store. Returns
    the settle kernel's launches in the delta step."""
    from bayesian_consensus_engine_tpu_torch import obs, pipeline
    from bayesian_consensus_engine_tpu_torch.core.batch import SourceCodes
    from bayesian_consensus_engine_tpu_torch.ops import settle_kernel
    from bayesian_consensus_engine_tpu_torch.state import journal
    from bayesian_consensus_engine_tpu_torch.state.tensor_store import (
        TensorReliabilityStore,
    )

    table = [f"src-{i}" for i in range(SOURCES)]

    def columns(markets):
        cut = int(offsets[markets])
        return (market_keys[:markets], SourceCodes(codes[:cut], table),
                probs[:cut], offsets[: markets + 1])

    def host_state(subject):
        subject.sync()
        used = len(subject)
        return (subject._rel[:used], subject._conf[:used],
                subject._days[:used], subject._exists[:used])

    def same_state(got, want, what):
        for name, x, y in zip(("rel", "conf", "days", "exists"),
                              host_state(got), host_state(want)):
            if not np.array_equal(x, y):
                raise AssertionError(f"{what}: {name} differs")
        used = len(want)
        if got._iso[:used] != want._iso[:used] or len(got) != used:
            raise AssertionError(f"{what}: ISO stamps or row count differ")
        if got._pairs.ids() != want._pairs.ids():
            raise AssertionError(f"{what}: row assignment differs")

    registry = obs.MetricsRegistry()
    previous = obs.set_metrics_registry(registry)
    seconds = {}
    try:
        # 1. A full-snapshot epoch of every row.
        path = os.path.join(work_dir, "main.jrnl")
        start = time.perf_counter()
        writer = journal.JournalWriter(path)
        snapshot_rows = store.flush_to_journal(writer, tag=0)
        seconds["snapshot_epoch"] = time.perf_counter() - start
        snapshot_end = os.path.getsize(path)
        if snapshot_rows != len(store):
            raise AssertionError(f"snapshot epoch: {snapshot_rows} rows of "
                                 f"{len(store)}")

        # 2. The delta: a plan over the first JOURNAL_MARKETS markets, one
        # settle (one settle_cycles launch), then an async epoch and an
        # async incremental flush to the main path's file, together.
        start = time.perf_counter()
        plan = pipeline.build_settlement_plan_columnar(
            store, *columns(JOURNAL_MARKETS))
        seconds["delta_plan"] = time.perf_counter() - start
        touched = int(np.unique(plan.slot_rows[plan.mask]).size)
        settle_kernel.LAUNCHES = 0
        start = time.perf_counter()
        result = pipeline.settle(store, plan, outcomes[:JOURNAL_MARKETS],
                                 steps=STEPS, now=JOURNAL_NOW)
        result.fence()
        seconds["delta_settle"] = time.perf_counter() - start
        launches = settle_kernel.LAUNCHES
        if launches != 1:
            raise AssertionError(f"{launches} kernel launches for 1 settle")
        consensus = result.consensus
        if consensus.shape != (JOURNAL_MARKETS,) or \
                not np.all(np.isfinite(consensus)):
            raise AssertionError("delta consensus is not finite of shape (M,)")
        start = time.perf_counter()
        epoch = store.flush_to_journal_async(writer, tag=1)
        seconds["journal_async_call"] = time.perf_counter() - start
        sqlite_start = time.perf_counter()
        flush = store.flush_to_sqlite_async(main_db)
        seconds["sqlite_async_call"] = time.perf_counter() - sqlite_start
        start = time.perf_counter()
        delta_rows = epoch.result()
        seconds["journal_result_wait"] = time.perf_counter() - start
        writer.close()
        delta_bytes = os.path.getsize(path) - snapshot_end
        if delta_rows != touched:
            raise AssertionError(f"delta epoch: {delta_rows} rows, the settle "
                                 f"touched {touched}")

        # 3. Replay on the card while the SQLite write runs, against the
        # live store; then the replayed store's full async flush against
        # the incremental file.
        start = time.perf_counter()
        replayed, tag = journal.replay_journal(path, device="cuda")
        seconds["replay"] = time.perf_counter() - start
        sqlite_done_after_replay = flush.done()
        start = time.perf_counter()
        sqlite_rows = flush.result()
        seconds["sqlite_result_wait"] = time.perf_counter() - start
        seconds["sqlite_async_total"] = time.perf_counter() - sqlite_start
        if tag != 1 or replayed.device.type != "cuda":
            raise AssertionError(f"replay: tag {tag}, {replayed.device}")
        start = time.perf_counter()
        same_state(replayed, store, "replayed store")
        seconds["replay_check"] = time.perf_counter() - start
        fresh_db = os.path.join(work_dir, "replayed.db")
        start = time.perf_counter()
        fresh_rows = replayed.flush_to_sqlite_async(fresh_db).result()
        seconds["replay_full_flush"] = time.perf_counter() - start
        # The main store's counters (the small checks below add to them).
        counters = {name: value for name, value
                    in registry.export()["counters"].items()
                    if name.startswith(("journal.", "interchange."))}
        if counters.get("interchange.delta_rows") != sqlite_rows:
            raise AssertionError(f"the flush to the main file was not "
                                 f"incremental: {counters}")
        if fresh_rows != len(store):
            raise AssertionError(f"replayed flush: {fresh_rows} rows of "
                                 f"{len(store)}")
        # The two checkpoints row for row (a join in SQLite; an ordered
        # digest of both 4M-row tables took ~30 s).
        start = time.perf_counter()
        compared = table_mismatches(main_db, fresh_db)
        seconds["table_compare"] = time.perf_counter() - start
        if compared[0] != compared[1] or compared[2]:
            raise AssertionError(f"checkpoints differ: {compared[0]} and "
                                 f"{compared[1]} rows, {compared[2]} differ")
        del replayed

        # 4. A small store: a torn tail, a resume after it, compaction and
        # the trace sidecar bounded by the journal's tag.
        small = TensorReliabilityStore()
        small_columns = columns(JOURNAL_SMALL_MARKETS)
        small_plan = pipeline.build_settlement_plan_columnar(small,
                                                             *small_columns)
        small_outcomes = outcomes[:JOURNAL_SMALL_MARKETS]
        small_path = os.path.join(work_dir, "small.jrnl")
        epoch_rows = []
        with journal.JournalWriter(small_path) as small_writer, \
                journal.TraceWriter(journal.trace_path_for(small_path)) as trace:
            for index in range(3):
                now = NOW + index * STEPS
                pipeline.settle(small, small_plan, small_outcomes, steps=STEPS,
                                now=now).fence()
                keys, sources, batch_probs, batch_offsets = small_columns
                trace.append_batch(keys, [table[c] for c in sources.codes.tolist()],
                                   batch_probs, batch_offsets, small_outcomes,
                                   now, STEPS)
                if index < 2:  # the third batch never becomes durable
                    epoch_rows.append(small.flush_to_journal(small_writer,
                                                             tag=index))
        raw = open(small_path, "rb").read()
        torn_path = os.path.join(work_dir, "torn.jrnl")
        with open(torn_path, "wb") as f:
            f.write(raw[:-7])  # mid-CRC of the second epoch
        torn, torn_tag = journal.replay_journal(torn_path, device="cuda")
        if torn_tag != 0 or len(torn) != len(small):
            raise AssertionError(f"torn tail: tag {torn_tag}, {len(torn)} rows")
        with journal.JournalWriter(torn_path, resume=True) as resumed:
            if resumed.epoch_index != 1:
                raise AssertionError(f"resume at epoch {resumed.epoch_index}")
            torn_plan = pipeline.build_settlement_plan_columnar(torn,
                                                                *small_columns)
            pipeline.settle(torn, torn_plan, small_outcomes, steps=STEPS,
                            now=JOURNAL_NOW).fence()
            torn.flush_to_journal(resumed, tag=5)
        again, again_tag = journal.replay_journal(torn_path, device="cuda")
        if again_tag != 5:
            raise AssertionError(f"resumed journal replays to tag {again_tag}")
        same_state(again, torn, "resumed journal")
        before, before_tag = journal.replay_journal(small_path, device="cuda")
        before_size = os.path.getsize(small_path)
        kept = journal.compact_journal(small_path, device="cuda")
        after, after_tag = journal.replay_journal(small_path, device="cuda")
        if (kept, before_tag, after_tag) != (len(small), 1, 1) or \
                os.path.getsize(small_path) >= before_size:
            raise AssertionError(f"compaction: {kept} rows, tags {before_tag} "
                                 f"-> {after_tag}")
        same_state(after, before, "compacted journal")
        batches = journal.read_trace(journal.trace_path_for(small_path),
                                     strict=True)
        covered, trace_tag = journal.extract_trace(small_path)
        if len(batches) != 3 or [b.index for b in covered] != [0, 1] or \
                trace_tag != 1:
            raise AssertionError(f"trace: {len(batches)} batches, "
                                 f"{len(covered)} covered, tag {trace_tag}")
        if not np.array_equal(batches[0].probabilities, small_columns[2]):
            raise AssertionError("trace batch 0 differs from its input")
        try:
            journal.extract_trace(small_path, strict=True)
        except journal.TornTraceError:
            pass
        else:
            raise AssertionError("strict extract_trace accepted a trace "
                                 "beyond the journal's tag")
    finally:
        obs.set_metrics_registry(previous)

    emit("journal", markets=len(market_keys), rows=len(store),
         snapshot_rows=snapshot_rows, snapshot_bytes=snapshot_end - len(
             journal.MAGIC),
         delta_markets=JOURNAL_MARKETS, delta_rows=delta_rows,
         delta_bytes=delta_bytes, launches=launches,
         sqlite_incremental_rows=sqlite_rows,
         sqlite_done_after_replay=sqlite_done_after_replay,
         replayed_rows=fresh_rows, sqlite_rows_compared=compared[0],
         small={"markets": JOURNAL_SMALL_MARKETS, "rows": len(small),
                "epoch_rows": epoch_rows, "torn_tag": torn_tag,
                "resumed_tag": again_tag, "compacted_rows": kept,
                "trace_batches": len(batches), "covered": len(covered)},
         counters=counters,
         seconds=seconds, nvidia_smi=smi)
    return launches


# stream: four batches of the main path's markets, one day apart.
STREAM_NOW, STREAM_SEED = NOW + 10 * STEPS, 17
JOURNAL_HEADER = "<QQQQQdQ"  # epoch, used_after, pair_len, dirty, iso_len,
                             # wall_unix_ts, tag


class GatedBatches:
    """The stream's batches, each released to the prefetch worker only
    once the stream has yielded the one before it (and so after that
    batch's checkpoint). A journal epoch records the pairs interned when
    it is snapshotted; an ungated worker interns the next batches' pairs
    while the current one settles, so the epochs' pair tables, and with
    them the journal bytes, would depend on thread timing."""

    def __init__(self, batches):
        import threading

        self._batches = batches
        self._released = threading.Semaphore(0)

    def __iter__(self):
        for index, batch in enumerate(self._batches):
            if index:
                self._released.acquire()
            yield batch

    def release(self):
        self._released.release()


def journal_digest(path):
    """Each epoch's header without its ``wall_unix_ts`` (and the CRC that
    covers it), and the sha256 of its payload: what two journals of the
    same work must share byte for byte."""
    import struct

    header = struct.Struct(JOURNAL_HEADER)
    epochs = []
    with open(path, "rb") as f:
        if f.read(8) != b"BCEJRNL1":
            raise AssertionError(f"{path}: not a journal")
        while raw := f.read(header.size):
            fields = header.unpack(raw)
            payload_len = fields[2] + 33 * fields[3] + fields[4]
            payload = f.read(payload_len)
            f.read(4)  # the CRC, which covers the wall clock
            epochs.append((fields[:5] + fields[6:],
                           hashlib.sha256(payload).hexdigest()))
    return epochs


def stream_batches(market_keys, codes, probs, offsets, outcomes):
    """The stream phase's four batches, ``((keys, source ids, probs,
    offsets), outcomes)`` each: the main path's batch, the same markets in
    the same order with new probabilities, then a drifted batch
    (:func:`drifted_batch`, its markets shuffled) twice."""
    rng = np.random.default_rng(STREAM_SEED)
    table = [f"src-{i}" for i in range(SOURCES)]
    sids = [table[c] for c in codes.tolist()]
    drift_keys, drift_codes, drift_probs, drift_offsets = drifted_batch(
        rng, market_keys, np.diff(offsets), codes)
    drift_sids = [table[c] for c in drift_codes.tolist()]
    columns = [
        (market_keys, sids, probs, offsets),
        (market_keys, sids, rng.random(len(probs)), offsets),
        (drift_keys, drift_sids, drift_probs, drift_offsets),
        (drift_keys, drift_sids, rng.random(len(drift_probs)), drift_offsets),
    ]
    batch_outcomes = [outcomes] + [rng.random(len(c[0])) < 0.5
                                   for c in columns[1:]]
    return list(zip(columns, batch_outcomes))


def main_data():
    """The main path's batch from SEED: ``(counts, codes, probs, offsets,
    outcomes, market_keys)``, MARKETS markets of Poisson(MEAN_SIGNALS - 1)
    + 1 signals from SOURCES sources."""
    data_rng = np.random.default_rng(SEED)
    counts = data_rng.poisson(MEAN_SIGNALS - 1, MARKETS) + 1
    codes = data_rng.integers(0, SOURCES, counts.sum())
    probs = data_rng.random(counts.sum())
    offsets = np.concatenate([[0], np.cumsum(counts)])
    outcomes = data_rng.random(MARKETS) < 0.5
    market_keys = [f"market-{m}" for m in range(MARKETS)]
    return counts, codes, probs, offsets, outcomes, market_keys


def stream_phase(smi, market_keys, codes, probs, offsets, outcomes):
    """The streamed, resident settlement service at the main path's width:
    four batches through a flat stream (A) and a resident stream with the
    observability on (R), each on a fresh card store; A's and R's stores
    bit-equal and journals byte-equal (wall clock masked). Returns the
    launches of ``settle_cycles`` in A and of ``onepass_settle`` in R, R's
    trace and R's store digest (the replay phase re-drives the trace)."""
    from bayesian_consensus_engine_tpu_torch import obs, pipeline
    from bayesian_consensus_engine_tpu_torch.cluster.recover import store_digest
    from bayesian_consensus_engine_tpu_torch.ops import (
        onepass_kernel,
        settle_kernel,
    )
    from bayesian_consensus_engine_tpu_torch.parallel.mesh import make_mesh
    from bayesian_consensus_engine_tpu_torch.state import journal
    from bayesian_consensus_engine_tpu_torch.state.tensor_store import (
        TensorReliabilityStore,
    )

    seconds = {}
    start = time.perf_counter()
    batches = stream_batches(market_keys, codes, probs, offsets, outcomes)
    seconds["data"] = time.perf_counter() - start
    work = tempfile.TemporaryDirectory()
    mesh = make_mesh((1, 1), [torch.device("cuda")])

    def host_state(store):
        store.sync()
        used = len(store)
        return (store._rel[:used], store._conf[:used], store._days[:used],
                store._exists[:used], store._pairs.ids())

    def same_state(got, want, what):
        for name, x, y in zip(("reliability", "confidence", "stamps",
                               "existence", "rows"), got, want):
            if (x != y) if name == "rows" else not np.array_equal(x, y):
                raise AssertionError(f"{what}: {name} differ")

    tails = {}

    def run(name, **kw):
        store = TensorReliabilityStore()
        stats = []
        gate = GatedBatches(batches)
        settle_kernel.LAUNCHES = 0
        onepass_kernel.LAUNCHES = 0
        results = []
        timeline = obs.active_timeline()
        start = time.perf_counter()
        last, mark = start, timeline.totals()
        for result in pipeline.settle_stream(
                store, gate, steps=STEPS, now=STREAM_NOW, columnar=True,
                reuse_plans=True, stats=stats,
                journal=os.path.join(work.name, f"{name}.jrnl"), **kw):
            results.append(result.consensus)
            gate.release()
            last, mark = time.perf_counter(), timeline.totals()
        end = time.perf_counter()
        launches = (settle_kernel.LAUNCHES, onepass_kernel.LAUNCHES)
        seconds[name] = end - start
        # After the last yield: the exit contract (the journal join, and
        # for R the SQLite tail flush).
        seconds[f"{name}_tail"] = end - last
        tails[name] = obs.PhaseTimeline.delta(mark, timeline.totals())
        for values, (batch_columns, _o) in zip(results, batches):
            if values.shape != (len(batch_columns[0]),) or \
                    not np.all(np.isfinite(values)):
                raise AssertionError(f"{name}: consensus is not finite of "
                                     "shape (M,)")
        return store, results, stats, launches

    # A: the flat stream (settle_cycles).
    store_a, consensus_a, stats_a, launches_a = run("A")
    if launches_a != (4, 0):
        raise AssertionError(f"flat stream launches (settle_cycles, "
                             f"onepass_settle): {launches_a}, expected (4, 0)")
    state_a = host_state(store_a)
    del store_a
    journal_a = journal_digest(os.path.join(work.name, "A.jrnl"))
    os.remove(os.path.join(work.name, "A.jrnl"))

    # R: the resident stream (onepass_settle) with the observability on, a
    # SQLite tail flush and the trace sidecar.
    registry = obs.MetricsRegistry()
    tracer = obs.Tracer()
    timeline = obs.PhaseTimeline()
    # The relayout's entering rows, as the session hands them over.
    entering = []
    real_relayout = pipeline.relayout_slot_state

    def recording_relayout(state, src, enter_pos, *args):
        entering.append(len(enter_pos))
        return real_relayout(state, src, enter_pos, *args)

    previous = obs.set_metrics_registry(registry)
    previous_tracer = obs.set_tracer(tracer)
    pipeline.relayout_slot_state = recording_relayout
    db_path = os.path.join(work.name, "R.db")
    trace_path = os.path.join(work.name, "R.trace")
    try:
        with obs.recording(timeline):
            store_r, consensus_r, stats_r, launches_r = run(
                "R", mesh=mesh, db_path=db_path, trace=trace_path)
    finally:
        pipeline.relayout_slot_state = real_relayout
        obs.set_metrics_registry(previous)
        obs.set_tracer(previous_tracer)
    adopts = [s["session_adopt"] for s in stats_r]
    reused = [s["plan_reused"] for s in stats_r]
    if adopts != ["start", "refresh", "relayout", "refresh"] or \
            reused != [False, True, False, True]:
        raise AssertionError(f"resident stream: session_adopt {adopts}, "
                             f"plan_reused {reused}")
    if launches_r != (0, 4):
        raise AssertionError(f"resident stream launches (settle_cycles, "
                             f"onepass_settle): {launches_r}, expected (0, 4)")
    export = registry.export()
    counters = {k: v for k, v in export["counters"].items()
                if k.startswith(("stream.", "ingest.", "intern."))}
    if counters.get("stream.resident_fallbacks", 0) != 0 or \
            counters.get("stream.session_adopts") != 1:
        raise AssertionError(f"resident stream counters: {counters}")
    state_r = host_state(store_r)
    start = time.perf_counter()
    digest_r = store_digest(store_r)
    seconds["R_digest"] = time.perf_counter() - start
    del store_r
    same_state(state_r, state_a, "A against R")
    journal_r = journal_digest(os.path.join(work.name, "R.jrnl"))
    if journal_r != journal_a:
        raise AssertionError("A against R: the journals differ")
    worst = 0.0
    for index, (got, want) in enumerate(zip(consensus_r, consensus_a)):
        worst = max(worst, check_consensus(
            torch.from_numpy(got), torch.from_numpy(want),
            f"A against R batch {index}"))
    with contextlib.closing(sqlite3.connect(db_path)) as conn:
        flushed_rows = conn.execute("SELECT COUNT(*) FROM sources").fetchone()[0]
    if flushed_rows != int(np.count_nonzero(state_r[3])):
        raise AssertionError(f"R's tail flush wrote {flushed_rows} rows")
    file_bytes = {name: os.path.getsize(os.path.join(work.name, name))
                  for name in ("R.jrnl", "R.trace", "R.db")}
    os.remove(db_path)

    # R's trace, for the replay phase (20): its lane 0 re-drives it and
    # must rebuild R's store (the re-drive this phase made through
    # drive_trace until the replay lab was ported).
    trace = journal.read_trace(trace_path, strict=True)
    work.cleanup()

    emit("stream", markets=len(market_keys), batches=len(batches),
         rows=len(state_r[0]), steps=STEPS, launches={
             "A_settle_cycles": launches_a[0], "R_onepass_settle": launches_r[1]},
         session_adopt=adopts, plan_reused=reused,
         entering_rows=entering, journal_epochs=len(journal_r),
         max_abs_consensus_err=worst,
         per_batch={key: [s[key] for s in stats_r]
                    for key in ("plan_wait_s", "settle_dispatch_s",
                                "checkpoint_s", "intern_s", "interned_pairs")},
         phases=[s["phases"] for s in stats_r], tail_phases=tails["R"],
         counters=counters,
         hbm={name: export["gauges"].get(name)
              for name in ("hbm.bytes_in_use", "hbm.peak_bytes")},
         trace_events=len(tracer.events()), file_bytes=file_bytes,
         sqlite_rows=flushed_rows, store_digest=digest_r, seconds=seconds,
         nvidia_smi=smi)
    return launches_a[0], launches_r[1], trace, digest_r


# serve: the request front door at the main path's width.
SERVE_NOW, SERVE_SEED = NOW + 40 * STEPS, 23
# Act A: client threads, requests per client, pipelined chunk. The clients
# run in a load-generator process of their own: as threads of this process
# they took the event loop's share of the interpreter lock, and a 5 ms
# window closed on ~16 requests.
SERVE_CLIENTS, SERVE_PER_CLIENT, SERVE_CHUNK = 16, 1024, 256
# Act B: premium closed-loop clients, the best-effort burst and budget.
OVERLOAD_CLIENTS, OVERLOAD_BURST, OVERLOAD_BUDGET = 8, 8192, 64
# Act C: the CLI's requests, its client threads and its serve duration.
CLI_REQUESTS, CLI_CLIENTS, CLI_DURATION = 8192, 4, 8.0
# The CLI runs on its default device unless this names one.
CLI_DEVICE = None
# The CLI subprocess: the package's CLI module run as ``-m`` runs it,
# reporting the settle kernel's launches on stderr as the process exits.
CLI_BOOT = """
import atexit, runpy, sys
from bayesian_consensus_engine_tpu_torch.ops import settle_kernel
atexit.register(lambda: print("settle_cycles_launches", settle_kernel.LAUNCHES,
                              file=sys.stderr, flush=True))
sys.argv = ["bce-torch", *sys.argv[1:]]
runpy.run_module("bayesian_consensus_engine_tpu_torch.cli", run_name="__main__",
                 alter_sys=True)
"""

# Act A's load generator: started first, it imports the client while this
# process seeds its store, then reads one JSON line (the server's port, the
# pickled per-client request lists, where to write the answers), runs one
# pipelining client per list on a thread of its own, writes the answers
# (a refusal as its type and message) and prints its clients' seconds.
LOADGEN_BOOT = """
import concurrent.futures, json, pickle, sys, time
from bayesian_consensus_engine_tpu_torch.net import ConsensusClient
from bayesian_consensus_engine_tpu_torch.serve import ServeResult
print("ready", flush=True)
job = json.loads(sys.stdin.readline())
with open(job["requests"], "rb") as handle:
    lists = pickle.load(handle)

def client(requests):
    out = []
    with ConsensusClient(port=job["port"], timeout=120.0) as conn:
        for first in range(0, len(requests), job["chunk"]):
            out += conn.submit_pipelined(requests[first:first + job["chunk"]])
    return [v if isinstance(v, ServeResult) else f"{type(v).__name__}: {v}"
            for v in out]

with concurrent.futures.ThreadPoolExecutor(len(lists)) as pool:
    began = time.perf_counter()
    answers = list(pool.map(client, lists))
    seconds = time.perf_counter() - began
with open(job["answers"], "wb") as handle:
    pickle.dump(answers, handle)
print(json.dumps({"seconds": seconds}), flush=True)
"""


def serve_phase(smi, market_keys, codes, probs, offsets, outcomes):
    """The request front door at the main path's width, over a store
    seeded by one flat settle of the main path's batch: (A) the resident
    service with analytics behind the socket server, 16 pipelining
    clients, and its batch log re-driven in lockstep on a fresh seeded
    store; (B) two tenant classes under a best-effort burst; (C) the
    CLI's ``serve`` in a subprocess on the card, then ``journal-export``
    and ``list-sources``. Returns the launches of ``settle_cycles`` (the
    seeding settles and the CLI) and of ``onepass_settle`` (A, its
    re-drive and B)."""
    loadgen = subprocess.Popen([sys.executable, "-c", LOADGEN_BOOT],
                               stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True)
    try:
        return _serve_acts(smi, market_keys, codes, probs, offsets, outcomes,
                           loadgen)
    finally:
        if loadgen.poll() is None:
            loadgen.kill()
            loadgen.wait(timeout=60)


def _serve_acts(smi, market_keys, codes, probs, offsets, outcomes, loadgen):
    """The body of :func:`serve_phase`, with act A's load generator
    started."""
    import asyncio
    import concurrent.futures
    import io
    import pickle
    import threading

    from bayesian_consensus_engine_tpu_torch import cli, obs, pipeline
    from bayesian_consensus_engine_tpu_torch.core.batch import (
        SourceCodes,
        topology_fingerprint,
    )
    from bayesian_consensus_engine_tpu_torch.net import (
        ConsensusClient,
        ConsensusServer,
    )
    from bayesian_consensus_engine_tpu_torch.ops import (
        onepass_kernel,
        settle_kernel,
    )
    from bayesian_consensus_engine_tpu_torch.parallel.mesh import make_mesh
    from bayesian_consensus_engine_tpu_torch.serve import (
        AdmissionConfig,
        ConsensusService,
        QosClass,
        ServeResult,
        drive_trace,
    )
    from bayesian_consensus_engine_tpu_torch.state import journal
    from bayesian_consensus_engine_tpu_torch.state.tensor_store import (
        TensorReliabilityStore,
    )

    seconds = {}
    start = time.perf_counter()
    table = [f"src-{i}" for i in range(SOURCES)]
    counts = np.diff(offsets)
    hot_markets = MARKETS // 10
    rng = np.random.default_rng(SERVE_SEED)

    def draw(n):
        """*n* requests: 80% on the hottest tenth of the markets, each
        market with its main-path sources, fresh probabilities and a fair
        outcome."""
        hot = rng.random(n) < 0.8
        chosen = np.where(hot, rng.integers(0, hot_markets, n),
                          rng.integers(0, MARKETS, n))
        fresh = rng.random(int(counts[chosen].sum()))
        fair = (rng.random(n) < 0.5).tolist()
        requests, cursor = [], 0
        for market, outcome in zip(chosen.tolist(), fair):
            lo, hi = int(offsets[market]), int(offsets[market + 1])
            sids = [table[c] for c in codes[lo:hi].tolist()]
            requests.append((market_keys[market],
                             list(zip(sids, fresh[cursor:cursor + hi - lo]
                                      .tolist())), outcome))
            cursor += hi - lo
        return requests

    act_a_requests = [draw(SERVE_PER_CLIENT) for _ in range(SERVE_CLIENTS)]
    premium_requests = draw(OVERLOAD_CLIENTS * 4096)
    burst_requests = draw(OVERLOAD_BURST)
    cli_requests = draw(CLI_REQUESTS)
    seconds["data"] = time.perf_counter() - start
    work = tempfile.TemporaryDirectory()
    mesh = make_mesh((1, 1), [torch.device("cuda")])
    seed_launches = []

    def seeded_store():
        """A card store holding the main path's ~4M rows after one flat
        20-step settle of the whole batch (one settle_cycles launch)."""
        store = TensorReliabilityStore()
        plan = pipeline.build_settlement_plan_columnar(
            store, market_keys, SourceCodes(codes, table), probs, offsets)
        settle_kernel.LAUNCHES = 0
        pipeline.settle(store, plan, outcomes, steps=STEPS,
                        now=SERVE_NOW - STEPS).fence()
        seed_launches.append(settle_kernel.LAUNCHES)
        if seed_launches[-1] != 1:
            raise AssertionError(f"seeding settle: {seed_launches[-1]} "
                                 "settle_cycles launches")
        return store

    def host_state(store):
        store.sync()
        used = len(store)
        return (store._rel[:used].copy(), store._conf[:used].copy(),
                store._days[:used].copy(), store._exists[:used].copy(),
                store._pairs.ids())

    def quantiles(registry, name):
        hist = registry.histogram(name)
        return {"p50": hist.quantile(0.5), "p99": hist.quantile(0.99),
                "count": hist.snapshot()["count"]}

    # -- Act A: the wire path over the resident session with analytics.
    start = time.perf_counter()
    store_a = seeded_store()
    seconds["seed_a"] = time.perf_counter() - start
    path_a = os.path.join(work.name, "A.jrnl")
    registry = obs.MetricsRegistry()
    tracer = obs.Tracer(log_capacity=None)
    previous = obs.set_metrics_registry(registry)
    previous_tracer = obs.set_tracer(tracer)

    async def act_a():
        service = ConsensusService(
            store_a, mesh=mesh, steps=STEPS, now=SERVE_NOW, journal=path_a,
            checkpoint_every=1, max_batch=4096, max_delay_s=0.005,
            analytics=True, record_batches=True, band_stderr_bound=1 << 21,
            admission=AdmissionConfig(max_pending=2 * SERVE_CLIENTS
                                      * SERVE_CHUNK))
        server = await ConsensusServer(service, host="127.0.0.1", port=0,
                                       acceptors=4).start()
        loop = asyncio.get_running_loop()
        loadgen.stdin.write(json.dumps({
            "port": server.port, "requests": requests_path,
            "answers": answers_path, "chunk": SERVE_CHUNK}) + "\n")
        loadgen.stdin.flush()
        report = await loop.run_in_executor(None, loadgen.stdout.readline)
        await server.close()
        await service.close()
        return service, report

    # The requests go to the load generator in a file; it answers in one.
    requests_path = os.path.join(work.name, "A.requests")
    answers_path = os.path.join(work.name, "A.answers")
    with open(requests_path, "wb") as handle:
        pickle.dump(act_a_requests, handle)
    start = time.perf_counter()
    if loadgen.stdout.readline().strip() != "ready":
        raise AssertionError(f"act A's load generator: {loadgen.stderr.read()}")
    seconds["loadgen_ready"] = time.perf_counter() - start

    onepass_kernel.LAUNCHES = 0
    settle_kernel.LAUNCHES = 0
    start = time.perf_counter()
    try:
        service_a, report = asyncio.run(act_a())
    finally:
        obs.set_metrics_registry(previous)
        obs.set_tracer(previous_tracer)
    launches_a = onepass_kernel.LAUNCHES
    seconds["act_a"] = time.perf_counter() - start
    if loadgen.wait(timeout=60) != 0 or not report:
        raise AssertionError(f"act A's load generator exited "
                             f"{loadgen.returncode}: {loadgen.stderr.read()}")
    elapsed_a = json.loads(report)["seconds"]
    with open(answers_path, "rb") as handle:
        answers = pickle.load(handle)
    os.remove(requests_path)
    os.remove(answers_path)
    if settle_kernel.LAUNCHES:
        raise AssertionError(f"act A launched settle_cycles "
                             f"{settle_kernel.LAUNCHES} times")
    served = [value for answer in answers for value in answer]
    refused = [value for value in served if not isinstance(value, ServeResult)]
    export = registry.export()
    counters = export["counters"]
    if len(served) != SERVE_CLIENTS * SERVE_PER_CLIENT or refused or \
            counters.get("net.wire_errors", 0) or \
            counters.get("net.responses") != len(served):
        raise AssertionError(f"act A: {len(served)} answers, {len(refused)} "
                             f"refused ({refused[:3]}), counters "
                             f"{ {k: v for k, v in counters.items() if k.startswith('net.')} }")
    if launches_a != len(service_a.batch_log) or \
            service_a.settled_batches != launches_a:
        raise AssertionError(f"act A: {launches_a} onepass_settle launches for "
                             f"{len(service_a.batch_log)} batches")
    for value in served:
        # A band is NaN where its read carries no weight, as the plain
        # version and the JAX package give it.
        if not (np.isfinite(value.consensus) and value.band_lo is not None
                and not value.band_lo > value.band_hi):
            raise AssertionError(f"act A: bad result {value}")
    batch_log = service_a.batch_log
    fingerprints = [topology_fingerprint(cols[0], cols[1], cols[3])
                    for cols, _o in batch_log]
    hits = sum(1 for a, b in zip(fingerprints, fingerprints[1:]) if a == b)
    sizes = [len(cols[0]) for cols, _o in batch_log]
    phases = {}
    for event in tracer.events():
        if event["scope"] == "batch" and event.get("dur_s") is not None:
            per = phases.setdefault(event["name"], [0.0, 0.0, 0])
            per[0] += event["dur_s"]
            per[1] = max(per[1], event["dur_s"])
            per[2] += 1
    act_a_report = {
        "requests": len(served), "seconds": elapsed_a,
        "requests_per_s": len(served) / elapsed_a,
        "latency_total_s": quantiles(registry, "serve.latency_total_s"),
        "latency_dispatch_s": quantiles(registry, "serve.latency_dispatch_s"),
        "latency_durable_s": quantiles(registry, "serve.latency_durable_s"),
        "batches": len(batch_log), "mean_fill": float(np.mean(sizes)),
        "max_fill": max(sizes), "plan_cache_hits": hits,
        "plan_cache_misses": len(batch_log) - hits,
        "session_adopts": counters.get("stream.session_adopts", 0),
        "ingest_wait_s": service_a.ingest_wait_s,
        "intern_wait_s": service_a.intern_wait_s,
        "phases": {name: {"sum_s": v[0], "max_s": v[1], "count": v[2]}
                   for name, v in sorted(phases.items())},
        "hbm": {name: export["gauges"].get(name)
                for name in ("hbm.bytes_in_use", "hbm.peak_bytes")},
        "onepass_settle_launches": launches_a,
        "trace_events": len(tracer.events()),
    }
    del tracer
    band_stderr = service_a.market_band_stderr
    start = time.perf_counter()
    state_a = host_state(store_a)
    seconds["host_state_a"] = time.perf_counter() - start

    # The batch log re-driven in lockstep on a fresh seeded store.
    start = time.perf_counter()
    store_d = seeded_store()
    trace = [journal.TraceBatch(index, tuple(keys), tuple(sids),
                                np.asarray(batch_probs), np.asarray(batch_offsets),
                                np.asarray(batch_outcomes), SERVE_NOW + index,
                                STEPS)
             for index, ((keys, sids, batch_probs, batch_offsets),
                         batch_outcomes) in enumerate(batch_log)]
    path_d = os.path.join(work.name, "D.jrnl")
    onepass_kernel.LAUNCHES = 0
    redriven = drive_trace(store_d, trace, mesh=mesh, journal=path_d,
                           checkpoint_every=1)
    launches_d = onepass_kernel.LAUNCHES
    seconds["redrive"] = time.perf_counter() - start
    start = time.perf_counter()
    state_d = host_state(store_d)
    seconds["host_state_d"] = time.perf_counter() - start
    del store_d, trace
    for name, x, y in zip(("reliability", "confidence", "stamps", "existence",
                           "rows"), state_d, state_a):
        if (x != y) if name == "rows" else not np.array_equal(x, y):
            raise AssertionError(f"act A against its re-drive: {name} differ")
    start = time.perf_counter()
    journal_a = journal_digest(path_a)
    if journal_digest(path_d) != journal_a:
        raise AssertionError("act A against its re-drive: the journals differ")
    seconds["journal_digests"] = time.perf_counter() - start
    if launches_d != len(batch_log):
        raise AssertionError(f"re-drive: {launches_d} launches for "
                             f"{len(batch_log)} batches")
    by_batch = [result.by_market() for result in redriven]
    differ = sum(1 for value in served
                 if by_batch[value.batch_index][value.market_id]
                 != value.consensus)
    if differ:
        raise AssertionError(f"act A against its re-drive: {differ} requests' "
                             "consensus differs")
    act_a_report.update(journal_epochs=len(journal_a),
                        journal_bytes=os.path.getsize(path_a),
                        redrive_launches=launches_d, rows=len(state_a[0]))
    emit("serve_act", act="A", phase_seconds=dict(seconds), **{
        key: act_a_report[key] for key in (
            "requests", "seconds", "requests_per_s", "batches",
            "latency_total_s", "phases")})
    del by_batch, redriven, state_d, served, answers, batch_log
    os.remove(path_a)
    os.remove(path_d)

    # -- Act B: two tenant classes, premium closed loop under a best-effort
    # burst, on act A's store.
    classes = [QosClass("premium", 1.0, OVERLOAD_BUDGET),
               QosClass("besteffort", 1.0, OVERLOAD_BUDGET,
                        policy="shed_oldest")]
    registry_b = obs.MetricsRegistry()
    previous = obs.set_metrics_registry(registry_b)
    peaks = {cls.name: 0 for cls in classes}
    victims = {"known": 0, "unknown": 0}

    async def act_b():
        service = ConsensusService(
            store_a, mesh=mesh, steps=STEPS, now=SERVE_NOW + 10_000,
            max_batch=4096, max_delay_s=0.005, analytics=True, qos=classes,
            band_stderr_bound=1 << 21)
        # The shed ranking imported from act A's analytics, as a recovered
        # service would; act B's own batches refresh it.
        service.seed_band_stderr(band_stderr)
        real_submit, real_shed = service.submit, service._shed_victim

        def submit(*args, **kwargs):
            try:
                return real_submit(*args, **kwargs)
            finally:
                for name, state in service._qos_states.items():
                    peaks[name] = max(peaks[name], state.pending)

        def shed_victim(class_name=None, feed_health=True):
            known_before = {
                id(request): request.market_id in service._band_stderr
                for window in service._windows for request in window.requests}
            shed = real_shed(class_name=class_name, feed_health=feed_health)
            if shed:
                left = {id(request) for window in service._windows
                        for request in window.requests}
                for key, known in known_before.items():
                    if key not in left:
                        victims["known" if known else "unknown"] += 1
            return shed

        service.submit, service._shed_victim = submit, shed_victim
        server = await ConsensusServer(service, host="127.0.0.1", port=0,
                                       acceptors=4).start()
        loop = asyncio.get_running_loop()
        burst_done = threading.Event()

        def premium(index):
            out = []
            with ConsensusClient(port=server.port, timeout=120.0) as conn:
                for number in range(4096):
                    request = premium_requests[index * 4096 + number]
                    out += conn.submit_pipelined([request], qos_class="premium")
                    if burst_done.is_set() and number >= 16:
                        break
            return out

        def burst():
            # Pipelined in chunks: a client that sends the whole burst
            # before reading fills the socket buffers both ways (the
            # server stops reading while its answers wait on a client
            # that is still sending) and the two deadlock.
            out = []
            try:
                with ConsensusClient(port=server.port, timeout=120.0) as conn:
                    for first in range(0, len(burst_requests), SERVE_CHUNK):
                        out += conn.submit_pipelined(
                            burst_requests[first:first + SERVE_CHUNK],
                            qos_class="besteffort")
                return out
            finally:
                burst_done.set()

        with concurrent.futures.ThreadPoolExecutor(OVERLOAD_CLIENTS + 1) as pool:
            began = time.perf_counter()
            premium_futures = [loop.run_in_executor(pool, premium, index)
                               for index in range(OVERLOAD_CLIENTS)]
            await asyncio.sleep(0.05)
            burst_answers = await loop.run_in_executor(pool, burst)
            premium_answers = await asyncio.gather(*premium_futures)
            elapsed = time.perf_counter() - began
        await server.close()
        await service.close()
        return service, premium_answers, burst_answers, elapsed

    onepass_kernel.LAUNCHES = 0
    try:
        service_b, premium_answers, burst_answers, elapsed_b = asyncio.run(
            act_b())
    finally:
        obs.set_metrics_registry(previous)
    launches_b = onepass_kernel.LAUNCHES
    premium_served = [v for answer in premium_answers for v in answer]
    premium_refused = [v for v in premium_served
                       if not isinstance(v, ServeResult)]
    names = [type(v).__name__ for v in burst_answers]
    snapshot = service_b.qos_snapshot()
    besteffort_refused = (snapshot["besteffort"]["counts"]["shed"]
                          + snapshot["besteffort"]["counts"]["rejected"])
    if premium_refused or snapshot["premium"]["counts"]["rejected"] or \
            snapshot["premium"]["counts"]["shed"]:
        raise AssertionError(f"act B: premium refused {premium_refused[:3]}")
    if besteffort_refused <= 0 or len(burst_answers) != OVERLOAD_BURST:
        raise AssertionError(f"act B: best effort refused {besteffort_refused}")
    if any(peaks[cls.name] > cls.max_pending for cls in classes):
        raise AssertionError(f"act B: pending peaks {peaks} over the budgets")
    if victims["known"] < 1:
        raise AssertionError(f"act B: no shed victim had a band: {victims}")
    if launches_b != service_b.settled_batches or launches_b < 1:
        raise AssertionError(f"act B: {launches_b} launches for "
                             f"{service_b.settled_batches} batches")
    act_b_report = {
        "seconds": elapsed_b, "premium_requests": len(premium_served),
        "burst": len(burst_answers),
        "burst_answers": {name: names.count(name) for name in sorted(set(names))},
        "goodput_per_s": {
            "premium": len(premium_served) / elapsed_b,
            "besteffort": names.count("ServeResult") / elapsed_b},
        "qos": snapshot, "pending_peaks": peaks, "shed_victims": victims,
        "seeded_band_stderr_markets": len(band_stderr),
        "batches": service_b.settled_batches, "onepass_settle_launches": launches_b,
        "latency_total_s": quantiles(registry_b, "serve.latency_total_s"),
    }
    emit("serve_act", act="B", seconds=elapsed_b,
         burst_answers=act_b_report["burst_answers"])
    del store_a, service_a, service_b, premium_answers, burst_answers
    del band_stderr

    # -- Act C: the CLI's serve on the card, then journal-export and
    # list-sources.
    device_args = ["--device", CLI_DEVICE] if CLI_DEVICE else []
    cli_journal = os.path.join(work.name, "cli.jrnl")
    start = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-c", CLI_BOOT, *device_args, "serve", "--port", "0",
         "--duration", str(CLI_DURATION), "--journal", cli_journal,
         "--qos", f"premium:1.0:{CLI_REQUESTS}"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        banner = json.loads(proc.stdout.readline())
        seconds["cli_banner"] = time.perf_counter() - start
        share = CLI_REQUESTS // CLI_CLIENTS

        def cli_client(index):
            with ConsensusClient(port=banner["port"], timeout=120.0) as conn:
                out = []
                for first in range(index * share, (index + 1) * share, 256):
                    out += conn.submit_pipelined(cli_requests[first:first + 256])
                return out

        began = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(CLI_CLIENTS) as pool:
            cli_answers = [v for answer in pool.map(cli_client,
                                                    range(CLI_CLIENTS))
                           for v in answer]
        seconds["cli_requests"] = time.perf_counter() - began
        stdout, stderr = proc.communicate(timeout=CLI_DURATION + 600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    seconds["cli_serve"] = time.perf_counter() - start
    if proc.returncode != 0:
        raise AssertionError(f"CLI serve exited {proc.returncode}: {stderr}")
    summary = json.loads(stdout)
    cli_launches = int(next(line.split()[1] for line in stderr.splitlines()
                            if line.startswith("settle_cycles_launches")))
    served_cli = summary["served"]
    if not (served_cli["requests"] == served_cli["responses"] == CLI_REQUESTS
            and served_cli["batches"] > 0 and served_cli["wireErrors"] == 0) \
            or any(not isinstance(v, ServeResult) for v in cli_answers) or \
            len(cli_answers) != CLI_REQUESTS:
        raise AssertionError(f"CLI serve: {summary}")
    if cli_launches != served_cli["batches"]:
        raise AssertionError(f"CLI serve: {cli_launches} settle_cycles "
                             f"launches for {served_cli['batches']} batches")
    # journal-export and list-sources through the CLI's main() in this
    # process (each subprocess would spend ~7 s importing torch).
    def run_cli(*argv):
        out, err = io.StringIO(), io.StringIO()
        code = 0
        previous_argv = sys.argv
        sys.argv = ["bce-torch", *argv]
        try:
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                cli.main()
        except SystemExit as exc:
            code = exc.code if isinstance(exc.code, int) else 1
        finally:
            sys.argv = previous_argv
        return code, out.getvalue(), err.getvalue()

    cli_db = os.path.join(work.name, "cli.db")
    start = time.perf_counter()
    code, out, err = run_cli(*device_args, "--db", cli_db, "journal-export",
                             cli_journal)
    seconds["cli_journal_export"] = time.perf_counter() - start
    if code != 0:
        raise AssertionError(f"journal-export: {code} {err}")
    export_doc = json.loads(out)
    hot_market = cli_requests[0][0]
    start = time.perf_counter()
    code, out, err = run_cli("--db", cli_db, "list-sources", "--market-id",
                             hot_market)
    seconds["cli_list_sources"] = time.perf_counter() - start
    listing = json.loads(out) if code == 0 else None
    want = {sid for sid, _p in cli_requests[0][1]}
    if listing is None or {r["sourceId"] for r in listing["sources"]} != want:
        raise AssertionError(f"list-sources: {code} {err} {listing}")
    work.cleanup()
    act_c_report = {
        "banner": banner, "summary": summary,
        "settle_cycles_launches": cli_launches,
        "journal_export": export_doc, "listed_sources": listing["count"],
    }
    emit("serve", markets=MARKETS, steps=STEPS, seed_launches=seed_launches,
         act_a=act_a_report, act_b=act_b_report, act_c=act_c_report,
         seconds=seconds, nvidia_smi=smi)
    return ({"seed": sum(seed_launches), "cli": cli_launches},
            {"A": launches_a, "A_redrive": launches_d, "B": launches_b})


# analytics_rest: the sorted tie-break and the standalone band program.
REST_NOW = NOW + 60 * STEPS


def analytics_rest_phase(smi, market_keys, codes, probs, offsets, outcomes):
    """The sorted tie-break and the standalone band program at the main
    path's width on the card's (1, 1) mesh. Returns the partials kernel's
    launches (two sorted calls, two band programs)."""
    from bayesian_consensus_engine_tpu_torch import pipeline
    from bayesian_consensus_engine_tpu_torch.analytics import (
        AnalyticsOptions,
        build_band_program,
    )
    from bayesian_consensus_engine_tpu_torch.core.batch import SourceCodes
    from bayesian_consensus_engine_tpu_torch.ops import (
        onepass_kernel,
        partials_kernel,
        settle_kernel,
    )
    from bayesian_consensus_engine_tpu_torch.ops import tiebreak as tiebreak_ops
    from bayesian_consensus_engine_tpu_torch.ops.cycle_math import (
        MarketBlockState,
    )
    from bayesian_consensus_engine_tpu_torch.parallel import sharded
    from bayesian_consensus_engine_tpu_torch.state.tensor_store import (
        TensorReliabilityStore,
    )

    seconds = {}
    sources = SourceCodes(codes, [f"src-{i}" for i in range(SOURCES)])
    # The sorted route hands its read views to batched_tiebreak: kept to
    # hold the card's tie-break against its plain run on the CPU.
    views = []
    real_tiebreak = sharded.batched_tiebreak

    def capturing(*args):
        out = real_tiebreak(*args)
        views.append((args, out))
        return out

    times = (REST_NOW, REST_NOW + STEPS + 9)  # the second call's reads decay
    runs = {}
    band_checks = []
    for kind, option in (("ring", True), ("sorted", "sorted")):
        start = time.perf_counter()
        store = TensorReliabilityStore()
        plan = pipeline.build_settlement_plan_columnar(
            store, market_keys, sources, probs, offsets)
        seconds[f"{kind}_plan"] = time.perf_counter() - start
        onepass_kernel.LAUNCHES = 0
        partials_kernel.LAUNCHES = 0
        settle_kernel.LAUNCHES = 0
        sharded.batched_tiebreak = capturing
        outputs, states = [], []
        try:
            session = pipeline.ShardedSettlementSession(store, plan)
            for call, now in enumerate(times, 1):
                if kind == "ring" and call == 2:
                    # The standalone band program on the block this call
                    # reads, with the state as it is: then the call itself.
                    (shard,), = session._state
                    program_args = (session._probs_g, session._mask_g,
                                    session._state, session._now0(now))
                    before = [x.clone() for x in shard]
                    program = build_band_program(session._mesh)
                    start = time.perf_counter()
                    program_bands = program(*program_args)
                    torch.cuda.synchronize()
                    seconds["band_program"] = time.perf_counter() - start
                    for got, want in zip(shard, before):
                        check_equal(got, want, "the band program's state")
                start = time.perf_counter()
                result, tiebreak, bands, _ = session.settle_with_analytics(
                    outcomes, steps=STEPS, now=now,
                    analytics=AnalyticsOptions(tiebreak=option))
                result.fence()
                seconds[f"{kind}_call_{call}"] = time.perf_counter() - start
                outputs.append((result.consensus, tiebreak, bands))
                (shard,), = session._state
                states.append([x.clone() for x in shard])
                if kind == "ring" and call == 2:
                    for name, values in zip(bands._fields, bands):
                        check_bits(getattr(program_bands, name),
                                   torch.from_numpy(np.asarray(values)),
                                   f"band program {name} vs the session's")
                    band_checks.append(len(bands._fields))
            session.close()
        finally:
            sharded.batched_tiebreak = real_tiebreak
        launches = (onepass_kernel.LAUNCHES, partials_kernel.LAUNCHES,
                    settle_kernel.LAUNCHES)
        expected = (2, 1, 0) if kind == "ring" else (0, 2, 0)
        if launches != expected:
            raise AssertionError(f"{kind} session launches (onepass, partials, "
                                 f"settle): {launches}, expected {expected}")
        runs[kind] = (outputs, states, launches)
        del store, plan, session
    if len(views) != 2 or not band_checks:
        raise AssertionError("the sorted route did not reach batched_tiebreak")
    # The sorted session's state bit-equal to the ring session's, call by
    # call; the consensus too (both kernels sum a market's slots in order).
    consensus_bit_equal = True
    worst = 0.0
    for call, (ring_state, sorted_state) in enumerate(
            zip(runs["ring"][1], runs["sorted"][1]), 1):
        for name, got, want in zip(STATE_NAMES, sorted_state, ring_state):
            check_equal(got, want, f"sorted vs ring state call {call} {name}")
        ring_c, sorted_c = runs["ring"][0][call - 1][0], runs["sorted"][0][call - 1][0]
        consensus_bit_equal &= bool(np.array_equal(ring_c, sorted_c,
                                                   equal_nan=True))
        worst = max(worst, check_consensus(torch.from_numpy(sorted_c),
                                           torch.from_numpy(ring_c),
                                           f"sorted vs ring consensus {call}"))
    # The card's sorted tie-break against its plain run on the CPU, on the
    # same views, call by call.
    for call, (args, out) in enumerate(views, 1):
        start = time.perf_counter()
        want = tiebreak_ops.batched_tiebreak(
            *(x.cpu() if isinstance(x, torch.Tensor) else x for x in args))
        seconds[f"cpu_tiebreak_{call}"] = time.perf_counter() - start
        for name, got, ref in zip(want._fields, out, want):
            check_bits(got, ref, f"sorted tie-break call {call} {name} vs CPU")
        if int((out.num_groups == 0).sum()) and not bool(
                torch.isnan(out.prediction[out.num_groups == 0]).all()):
            raise AssertionError("an empty market's sorted prediction is not NaN")
    sorted_tiebreak = runs["sorted"][0][1][1]
    resolved = np.bincount(np.asarray(sorted_tiebreak.resolved_by), minlength=3)
    # Times of the sorted tie-break's eager stage and of the band program.
    args, _out = views[1]
    tiebreak_ms, tiebreak_paced_by = time_window(
        lambda a: tiebreak_ops.batched_tiebreak(*a), lambda: args,
        warmup=1, runs=5)
    band_ms, band_paced_by = time_window(
        lambda a: program(*a), lambda: program_args, warmup=2, runs=11)
    emit("analytics_rest", markets=MARKETS, steps=STEPS, calls=len(times),
         launches={kind: dict(zip(("onepass_settle", "onepass_partials",
                                   "settle_cycles"), runs[kind][2]))
                   for kind in runs},
         state_bit_equal=True, consensus_bit_equal=consensus_bit_equal,
         max_abs_consensus_err=worst, tiebreak_vs_cpu="bit-equal",
         resolved_by_counts=resolved.tolist(),
         band_program_vs_session="bit-equal", band_program_state="unchanged",
         sorted_tiebreak_ms=tiebreak_ms,
         sorted_tiebreak_paced_by=tiebreak_paced_by,
         band_program_ms=band_ms, band_program_paced_by=band_paced_by,
         seconds=seconds, nvidia_smi=smi)
    return runs["sorted"][2][1] + runs["ring"][2][1]


STATE_NAMES = ("reliability", "confidence", "updated_days", "exists")
# replay: the sweep's lanes, as the JAX bench's grid walks its four knobs
# (bench.py:4310-4318): 16 configs, lane 0 the recorded one.
REPLAY_CONFIGS = 16
# The lane kernel's scaling: lane counts it is timed at on the last batch
# (beyond 16, the captured lanes repeated).
LANE_SCALING = (1, 4, 16, 64)


def replay_configs(replay):
    return [replay.RECORDED_CONFIG] + [
        replay.ReplayConfig(
            half_life_days=15.0 + 5.0 * (i % 4),
            base_learning_rate=0.04 + 0.02 * (i % 3),
            max_update_step=0.06 + 0.03 * (i % 3),
            band_z=1.25 + 0.25 * (i % 4),
        )
        for i in range(REPLAY_CONFIGS - 1)
    ]


def replay_phase(smi, trace, live_digest, ptxas):
    """``replay_sweep`` over the stream phase's trace with 16 configs; the
    lane kernel's check and timing. Returns the kernels-line entry of
    ``settle_cycles_lanes`` and the settle kernel's launches (lane 0)."""
    from bayesian_consensus_engine_tpu_torch import replay
    from bayesian_consensus_engine_tpu_torch.ops import settle_kernel
    from bayesian_consensus_engine_tpu_torch.parallel import sharded
    from bayesian_consensus_engine_tpu_torch.serve import driver

    configs = replay_configs(replay)
    steps = int(trace[0].steps)
    seconds = {}
    per_batch = {"plan": [], "lane0": [], "lane_launch": [], "step": []}
    # Host seconds a batch: the plan (stage + bind), lane 0's dispatch and
    # checkpoint, the lanes' launch and the whole step (band widths,
    # launch, metrics), each closed by a synchronise.
    real_plan_for = driver.PlanCache.plan_for
    real_dispatch = driver.SessionDriver.dispatch
    real_lanes = sharded.settle_cycles_lanes
    captured = {}
    # Per lane launch, the share of its (tile, lane) pairs that a block
    # settled for a group of lanes through one read of the plan (the
    # tiles whose markets lie in row order), from the launch's route
    # report; None where the launch reported no tiles (the CPU path).
    group_share = {"sweep": [], "sweep_again": [], "single": []}
    shares = []

    def reporting_lanes(*args, **kwargs):
        routes = torch.zeros(settle_kernel.LANE_ROUTE_SLOTS,
                             dtype=torch.int32, device=args[0].device)
        out = real_lanes(*args, routes=routes, **kwargs)
        staged, wide, _stage, grouped = routes.tolist()[:4]
        shares.append(grouped / (staged + wide) if staged + wide else None)
        return out

    def timed(key, fn):
        def wrapper(*args, **kwargs):
            start = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            per_batch[key].append(time.perf_counter() - start)
            return out
        return wrapper

    def capturing_lanes(*args, **kwargs):
        batch = len(per_batch["lane_launch"])
        if batch in (0, len(trace) - 1):
            # The first and the last batch's inputs, before the launch
            # moves them.
            captured[batch] = [a.clone() if isinstance(a, torch.Tensor)
                               else a for a in args]
        return timed("lane_launch", reporting_lanes)(*args, **kwargs)

    step = sharded.build_replay_sweep_step(steps, 0)
    sharded._REPLAY_SWEEP_CACHE[(steps, 0)] = timed("step", step)
    driver.PlanCache.plan_for = timed("plan", real_plan_for)
    driver.SessionDriver.dispatch = timed("lane0", real_dispatch)
    sharded.settle_cycles_lanes = capturing_lanes
    try:
        settle_kernel.LAUNCHES = 0
        settle_kernel.LANE_LAUNCHES = 0
        start = time.perf_counter()
        first = replay.replay_sweep(trace, configs, device="cuda")
        seconds["sweep"] = time.perf_counter() - start
        launches = (settle_kernel.LAUNCHES, settle_kernel.LANE_LAUNCHES)
    finally:
        sharded._REPLAY_SWEEP_CACHE[(steps, 0)] = step
        driver.PlanCache.plan_for = real_plan_for
        driver.SessionDriver.dispatch = real_dispatch
        sharded.settle_cycles_lanes = real_lanes
    group_share["sweep"], shares = shares, []
    if launches != (len(trace), len(trace)):
        raise AssertionError(f"replay launches (settle_cycles, "
                             f"settle_cycles_lanes): {launches}, expected one "
                             "each a batch")
    if first.digest != live_digest:
        raise AssertionError("lane 0's rebuild differs from the live stream's "
                             "store")
    settled = [lane.markets_settled for lane in first.lanes]
    if len(set(settled)) != 1 or settled[0] <= 0:
        raise AssertionError(f"lanes settled {settled} markets")
    metrics = np.float64([[lane.brier_sum, lane.band_width_sum,
                           lane.graph_brier_sum] for lane in first.lanes])
    if not np.all(np.isfinite(metrics)) or len(np.unique(metrics[:, 1])) < 4:
        raise AssertionError("lane metrics not finite, or the lanes' band "
                             "widths did not move with their z")
    reliability = first.lane_state[0]
    if np.array_equal(reliability[0], reliability[1]):
        raise AssertionError("an altered lane did not diverge")
    first_lanes, first_state = first.lanes, first.lane_state
    lane0_digest, result_digest = first.digest, first.result_digest
    del first, reliability  # the lane-0 store with it

    sharded.settle_cycles_lanes = reporting_lanes
    try:
        start = time.perf_counter()
        second = replay.replay_sweep(trace, configs, rebuild=False,
                                     device="cuda")
        seconds["sweep_again"] = time.perf_counter() - start
        group_share["sweep_again"], shares = shares, []
        if second.lanes != first_lanes or any(
                a.tobytes() != b.tobytes()
                for a, b in zip(second.lane_state, first_state)):
            raise AssertionError("a second sweep gave other lane metrics or "
                                 "state")
        del second, first_state
        altered = configs[5]
        start = time.perf_counter()
        alone = replay.replay_single(trace, altered, device="cuda")
        seconds["single"] = time.perf_counter() - start
        group_share["single"], shares = shares, []
    finally:
        sharded.settle_cycles_lanes = real_lanes
    lane = dict(zip(configs, first_lanes))[altered]
    if alone.markets_settled != lane.markets_settled or not (
            np.isclose(alone.brier_sum, lane.brier_sum, rtol=1e-6, atol=0)
            and np.isclose(alone.band_width_sum, lane.band_width_sum,
                           rtol=1e-6, atol=0)):
        raise AssertionError(f"replay_single {alone} vs the sweep's {lane}")

    # The lane kernel against its plain version on the first and the last
    # batch's lanes, at the main path's shapes (their staging and routes
    # are those of the timed launches below): the plain version is
    # functional, the kernel runs on clones, and every output must be
    # bit-equal. The first batch's rows lie in its markets' order (the
    # store interned them from it), so its tiles take the shared plan; the
    # last batch's markets come shuffled, so its tiles take a block a lane.
    full_args, first_args = captured[len(trace) - 1], captured[0]
    (rel, conf, days, exists, slot_rows, probs_d, mask_d, outcome_d, offsets_d,
     num_touched, now0, lane_steps, params) = full_args
    start = time.perf_counter()
    lanes_err = 0.0
    for batch, args in (("last", full_args), ("first", first_args)):
        want = settle_kernel.settle_cycles_lanes_reference(*args)
        got = settle_kernel.settle_cycles_lanes(
            *[a.clone() if isinstance(a, torch.Tensor) else a for a in args])
        torch.cuda.synchronize()
        for name, x, y in zip(STATE_NAMES + ("consensus",), got, want):
            check_bits(x, y, f"settle_cycles_lanes {name} vs its plain "
                       f"version, {batch} batch")
            if y.is_floating_point():
                finite = ~torch.isnan(y)
                lanes_err = max(lanes_err, float(
                    (x[finite] - y[finite]).abs().max())
                    if finite.any() else 0.0)
        del want, got
    seconds["lane_check"] = time.perf_counter() - start
    # Its time at the full shape, launched in place on the captured lanes
    # after a warm-up launch: every masked row then exists, the steady
    # state the byte bound counts.
    settle_kernel.settle_cycles_lanes(*full_args)
    lanes_ms = time_cuda(lambda a: settle_kernel.settle_cycles_lanes(*a),
                         lambda: full_args, warmup=2, runs=21)
    plain_ms, plain_paced_by = time_window(
        lambda a: settle_kernel.settle_cycles_lanes_reference(*a),
        lambda: full_args, warmup=1, runs=3)

    def bound_of(args, count):
        """The byte bound of a launch over the first ``count`` lanes of
        ``args``' (the 16 repeated beyond 16), as they stand."""
        rows = args[4][args[6]].long()
        existing = [int(args[3][c % len(configs)][rows].sum())
                    for c in range(count)]
        return settle_kernel.lanes_bound_bytes(
            count, int(args[4].shape[0]), int(args[4].shape[1]),
            int(args[9]), existing, lane_steps, 4)

    bound = bound_of(full_args, len(configs))

    def lane_scaling(args, ms_at_all):
        """The launch at each C of LANE_SCALING lanes, in place on
        ``args``' first C lanes (the 16 repeated up to C), its time a lane
        against its bound; at C = 16, ``ms_at_all`` when given."""
        entries = []
        for count in LANE_SCALING:
            if count == len(configs) and ms_at_all is not None:
                ms = ms_at_all
            else:
                reps = -(-count // len(configs))
                lanes_args = [
                    *(x.repeat(reps, 1)[:count].contiguous() for x in args[:4]),
                    *args[4:12],
                    args[12].repeat(reps, 1)[:count].contiguous()]
                ms = time_cuda(lambda a: settle_kernel.settle_cycles_lanes(*a),
                               lambda: lanes_args, warmup=2, runs=21)
                del lanes_args
            bound_bytes = bound_of(args, count)
            entries.append({
                "lanes": count, "ms": ms, "ms_per_lane": ms / count,
                "bound_bytes": bound_bytes,
                "bound_ms": bound_bytes / HBM_BYTES_PER_S * 1e3})
        return entries

    # The lane scaling on the last batch (lane 0 alone, C = 1, is the time
    # of one lane) and on the first, whose tiles share the plan.
    scaling = lane_scaling(full_args, lanes_ms)
    one_lane_ms = scaling[LANE_SCALING.index(1)]["ms"]
    settle_kernel.settle_cycles_lanes(*first_args)  # every row exists
    first_scaling = lane_scaling(first_args, None)
    del first_args, captured
    # The separation: the main path's kernel, with the recorded constants,
    # on lane 0's state (clones) and the last batch's plan, in place.
    # Beside the lane kernel at one lane it shows what the replay plan's
    # rows cost any kernel, apart from the lane instantiation.
    lane0 = [x[0].clone() for x in full_args[:4]] + list(full_args[4:12])
    settle_lane0_ms = time_cuda(lambda a: settle_kernel.settle_cycles(*a),
                                lambda: lane0, warmup=2, runs=21)
    del lane0
    routes = torch.zeros(settle_kernel.LANE_ROUTE_SLOTS, dtype=torch.int32,
                         device=rel.device)
    settle_kernel.settle_cycles_lanes(*full_args, routes=routes)
    staged, wide, stage_slots, _grouped, shared_bytes, group_lanes = (
        routes.tolist())
    emit("replay", batches=len(trace), lanes=len(configs), steps=steps,
         rows=int(rel.shape[1]), markets_settled=settled[0],
         launches={"settle_cycles": launches[0],
                   "settle_cycles_lanes": launches[1]},
         group_share=group_share,
         lane0_digest=lane0_digest, result_digest=result_digest,
         run_twice="equal", single_vs_sweep="equal",
         lane_reports=[{"config": dict(lane.config._asdict()),
                 "brier_mean": lane.brier_mean,
                 "band_width_mean": lane.band_width_mean}
                for lane in first_lanes],
         per_batch_seconds=per_batch, seconds=seconds,
         check_markets=int(slot_rows.shape[1]), nvidia_smi=smi)
    entry = {
        "name": "settle_cycles_lanes",
        "route": "cuda",
        "source": "bayesian_consensus_engine_tpu_torch/csrc/settle_cycles.cu",
        "replaces": "bayesian_consensus_engine_tpu/ops/pallas_cycle.py:95",
        "launches": launches[1],
        "max_abs_err": lanes_err,
        "ms": lanes_ms,
        "kernel_ms": lanes_ms,
        "plain_ms": plain_ms,
        "plain_paced_by": plain_paced_by,
        "bound_ms": bound / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "bound_bytes": bound,
        "library_ms": None,
        "lanes": len(configs),
        "one_lane_ms": one_lane_ms,
        "one_lane_bound_ms": scaling[LANE_SCALING.index(1)]["bound_ms"],
        "lane_scaling": scaling,
        # The same at the first batch, whose tiles share the plan.
        "lane_scaling_first_batch": first_scaling,
        # The main path's kernel on lane 0's captured state and plan.
        "settle_cycles_lane0_ms": settle_lane0_ms,
        # Per lane launch of the sweep, the second sweep and replay_single,
        # the share of (tile, lane) pairs settled through a shared plan.
        "group_share": group_share,
        "markets": int(slot_rows.shape[1]),
        "stage_slots": stage_slots,
        # The launch's own report: a block's shared memory (its lanes'
        # rates and the stage) and the most lanes a block of a tile in row
        # order takes at 16 lanes.
        "shared_bytes": shared_bytes,
        "group_lanes": group_lanes,
        "tiles": staged + wide,
        "wide_tiles": wide,
        # ptxas' figures of the lane instantiations, float32 and float64,
        # with a 32-bit step counter and (``_steps64``) a 64-bit one.
        "ptxas": {f"{dt}{suffix}": next(
            (figures for name, figures in ptxas["settle_cycles.cu"].items()
             if f"settle_cycles_lanes_kernelI{code}{n}E" in name), None)
                  for dt, code in (("float32", "f"), ("float64", "d"))
                  for suffix, n in (("", "i"), ("_steps64", "l"))},
    }
    return entry, launches[0]


# Phase 21: the one-process multi-shard tier. The inference path's graph on
# markets-sharded meshes of the card, the banded halo sweep, and the JAX
# bench's large-K shape (bench.py:133-135) and north-star band
# (bench.py:137-145) through the ring and counter-compact loops.
SHARDS_NOW = NOW + 80 * STEPS
SHARD_MESHES = ((4, 1), (2, 2))
PARITY_MESHES = (None, (2, 1), (4, 1), (2, 2))
BAND_SPLITS = (4, 16)
LARGE_K_MARKETS, LARGE_K_SLOTS, LARGE_K_STEPS = 16_384, 10_000, 50
NORTH_STAR_MARKETS, NORTH_STAR_SLOTS, NORTH_STAR_STEPS = 125_056, 10_000, 40
# The ring consensus against the flat loop's: the reference's own bound
# (tests/test_ring.py). Decoded compact state against the float32 loop's:
# its compact pin (tests/test_compact.py).
RING_BOUND = dict(rtol=2e-6, atol=1e-6)
COMPACT_BOUND = dict(rtol=1e-6, atol=1e-6)


def timed_run(fn):
    """``(result, seconds)`` of ``fn()`` between two synchronises."""
    torch.cuda.synchronize()
    start = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - start


def device_bits(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    """:func:`check_bits` on the tensors' device, for blocks too large to
    copy to the host: float bits compared through an integer view, a NaN
    as a NaN."""
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{what}: dtype or shape differs")
    if not want.dtype.is_floating_point:
        same = bool(torch.equal(got, want))
    else:
        view = {torch.float32: torch.int32, torch.float64: torch.int64}[want.dtype]
        nan = torch.isnan(want)
        same = bool(torch.equal(torch.isnan(got), nan)) and bool(
            ((got.view(view) == want.view(view)) | nan).all())
    if not same:
        raise AssertionError(f"{what}: not bit-equal")


def device_close(got, want, bound, what) -> float:
    """Within *bound* on the tensors' device, NaNs in the same places;
    returns the largest difference."""
    nan = torch.isnan(want)
    if not bool(torch.equal(torch.isnan(got), nan)):
        raise AssertionError(f"{what}: NaNs differ")
    if not bool(torch.isclose(got, want, equal_nan=True, **bound).all()):
        raise AssertionError(f"{what}: outside {bound}")
    return float(torch.where(nan, 0.0, (got.double() - want.double()).abs()).max())


def shards_phase(smi, market_keys, codes, probs, offsets, outcomes, graph):
    """Phase 21. Returns ``bp_sweep``'s launches on the markets-sharded
    sessions and the banded sweeps."""
    from bayesian_consensus_engine_tpu_torch import infer, pipeline
    from bayesian_consensus_engine_tpu_torch.analytics import AnalyticsOptions
    from bayesian_consensus_engine_tpu_torch.core.batch import SourceCodes
    from bayesian_consensus_engine_tpu_torch.infer import partition
    from bayesian_consensus_engine_tpu_torch.ops import bp_kernel
    from bayesian_consensus_engine_tpu_torch.ops.cycle_math import (
        MarketBlockState,
        _cycle_math,
        _fast_cycle_math,
        make_loop_math,
    )
    from bayesian_consensus_engine_tpu_torch.parallel import compact, ring
    from bayesian_consensus_engine_tpu_torch.parallel import mesh as mesh_module
    from bayesian_consensus_engine_tpu_torch.parallel import sharded
    from bayesian_consensus_engine_tpu_torch.state.tensor_store import (
        TensorReliabilityStore,
    )

    seconds, report = {}, {}
    sources = SourceCodes(codes, [f"src-{i}" for i in range(SOURCES)])
    card = torch.device("cuda")
    options = AnalyticsOptions(graph=graph, inference=infer.InferenceOptions(
        tol=BP_TOL, max_steps=BP_MAX_STEPS))

    # a. The graph on markets-sharded meshes: the one-card session, then
    # (4, 1) and (2, 2), each on a fresh store of the main path's batch.
    part = time.perf_counter()
    captured = []
    real_bp = sharded.bp_sweep

    def capturing(means, variances, neighbor_idx, neighbor_w, **sweep):
        seeds = (means.clone(), None if variances is None else variances.clone(),
                 neighbor_idx, neighbor_w)
        out = real_bp(means, variances, neighbor_idx, neighbor_w, **sweep)
        captured.append((seeds, sweep, tuple(
            None if x is None else x.clone() for x in out)))
        return out

    runs, session_launches = {}, {}
    for shape in (None, *SHARD_MESHES):
        name = "1x1" if shape is None else f"{shape[0]}x{shape[1]}"
        start = time.perf_counter()
        store = TensorReliabilityStore()
        plan = pipeline.build_settlement_plan_columnar(
            store, market_keys, sources, probs, offsets)
        seconds[f"{name}_plan"] = time.perf_counter() - start
        mesh = None if shape is None else mesh_module.make_mesh(
            shape, [card] * (shape[0] * shape[1]))
        captured.clear()
        counts, outputs = [], []
        sharded.bp_sweep = capturing
        try:
            bp_kernel.LAUNCHES = 0
            with pipeline.ShardedSettlementSession(store, plan, mesh) as session:
                for call, now in enumerate((SHARDS_NOW, SHARDS_NOW + STEPS), 1):
                    start = time.perf_counter()
                    result, _tb, _bands, propagated = session.settle_with_analytics(
                        outcomes, steps=STEPS, now=now, analytics=options)
                    result.fence()
                    seconds[f"{name}_call_{call}"] = time.perf_counter() - start
                    counts.append(bp_kernel.LAUNCHES)
                    outputs.append((np.asarray(result.consensus),
                                    np.asarray(propagated.mean),
                                    np.asarray(propagated.stderr),
                                    int(propagated.iters_run)))
        finally:
            sharded.bp_sweep = real_bp
        per_call = bp_kernel.launches_per_call(BP_MAX_STEPS)
        if counts != [per_call, 2 * per_call] or len(captured) != 2:
            raise AssertionError(f"{name}: bp_sweep launches after each call "
                                 f"{counts}, expected {[per_call, 2 * per_call]}")
        session_launches[name] = counts[-1]
        # Each call's sweep against one whole-axis launch on its seeds, and
        # the session's means and stderrs against that launch's.
        for call, ((seeds, sweep, got), out) in enumerate(
                zip(captured, outputs), 1):
            want = bp_kernel.bp_sweep(*seeds, **sweep)
            compare_sweep(got, want, f"{name} call {call} sweep")
            live = len(market_keys)
            check_bits(torch.from_numpy(out[1]), want[0][:live].cpu(),
                       f"{name} call {call} means")
            check_bits(torch.from_numpy(out[2]),
                       torch.sqrt(want[1][:live].double()).float().cpu(),
                       f"{name} call {call} stderrs")
        runs[name] = (list(captured), outputs)
        del store, plan, session
    one_card = runs["1x1"]
    seeds_equal = {}
    for name in runs:
        if name == "1x1":
            continue
        equal = []
        for (seeds, _s, got), (seeds_1, _s1, got_1), out, out_1 in zip(
                runs[name][0], one_card[0], runs[name][1], one_card[1]):
            same = all(torch.equal(a, b) for a, b in zip(seeds[:2], seeds_1[:2]))
            equal.append(same)
            if same:
                compare_sweep(got, got_1, f"{name} vs one card")
                for a, b, field in zip(out[1:3], out_1[1:3], ("means", "stderrs")):
                    check_bits(torch.from_numpy(a), torch.from_numpy(b),
                               f"{name} {field} vs one card")
        seeds_equal[name] = equal
        if name == "4x1" and torch.cuda.is_available() and not all(equal):
            # Each markets shard runs the one-card kernel on its columns,
            # one thread a market. (The CPU's plain version is not held to
            # this: its vectorised exp2 rounds by position in a shard.)
            raise AssertionError("4x1: the sweep's seeds differ from the "
                                 "one-card session's")
    report["sessions"] = dict(launches=session_launches, seeds_equal=seeds_equal,
                              iters_run={k: [o[3] for o in v[1]]
                                         for k, v in runs.items()})

    seconds["a_sessions"] = time.perf_counter() - part
    part = time.perf_counter()
    # The graph on and off the markets shards leaves the same SQLite bytes.
    small_keys = market_keys[:PARITY_MARKETS]
    cut = int(offsets[PARITY_MARKETS])
    small_blocks, small_edges = inference_graph(small_keys, SEED + 2, infer)
    small_options = AnalyticsOptions(
        graph=small_blocks.to_graph(extra_edges=small_edges), blocks=small_blocks,
        inference=infer.InferenceOptions(tol=BP_TOL, max_steps=BP_MAX_STEPS))
    dumps = {}
    with tempfile.TemporaryDirectory() as tmp:
        for shape in PARITY_MESHES:
            small = TensorReliabilityStore()
            small_plan = pipeline.build_settlement_plan_columnar(
                small, small_keys, SourceCodes(codes[:cut], sources.table),
                probs[:cut], offsets[: PARITY_MARKETS + 1])
            small_mesh = None if shape is None else mesh_module.make_mesh(
                shape, [card] * (shape[0] * shape[1]))
            with pipeline.ShardedSettlementSession(small, small_plan,
                                                   small_mesh) as s:
                for now in (NOW, NOW + STEPS):
                    s.settle_with_analytics(
                        outcomes[:PARITY_MARKETS], steps=STEPS, now=now,
                        analytics=small_options)
            path = os.path.join(tmp, f"{shape}.db")
            small.flush_to_sqlite(path)
            with open(path, "rb") as handle:
                dumps[str(shape)] = handle.read()
    if len(set(dumps.values())) != 1:
        raise AssertionError(f"SQLite bytes differ across meshes: {list(dumps)}")

    seconds["a_parity"] = time.perf_counter() - part
    part = time.perf_counter()
    # b. The banded halo sweep on the one-card session's second sweep: its
    # seeds and aligned blocks split into contiguous bands.
    (means, variances, idx, weights), sweep, whole = one_card[0][1]
    start = time.perf_counter()
    idx_host, weights_host = idx.cpu().numpy(), weights.cpu().numpy()
    seconds["blocks_to_host"] = time.perf_counter() - start
    banded_report, banded_launches = {}, 0
    for count in BAND_SPLITS:
        cuts = np.linspace(0, idx_host.shape[0], count + 1).astype(np.int64)
        start = time.perf_counter()
        banded = partition.partition_csr(idx_host, weights_host,
                                         list(zip(cuts[:-1], cuts[1:])))
        partition_s = time.perf_counter() - start
        # Each band step's operands in the first iteration, kept to time
        # its launch afterwards in a window the host cannot pace.
        steps_seen = []
        real_step = partition.bp_sweep

        def keeping(*args, **kwargs):
            if len(steps_seen) < count:
                steps_seen.append((tuple(None if x is None else x.clone()
                                         for x in args), kwargs))
            return real_step(*args, **kwargs)

        partition.bp_sweep = keeping
        try:
            bp_kernel.LAUNCHES = 0
            got, sweep_s = timed_run(lambda: partition.banded_bp_sweep(
                means, variances, banded, damping=sweep["damping"],
                max_steps=sweep["max_steps"], tol=sweep["tol"]))
            launches = bp_kernel.LAUNCHES
        finally:
            partition.bp_sweep = real_step
        iters = int(whole[2])
        if launches != count * iters:
            raise AssertionError(f"{count} bands: {launches} launches, expected "
                                 f"{count} x {iters}")
        compare_sweep(got, whole, f"{count} bands vs the whole-axis sweep")
        # The device time of an iteration's launches: each band's step
        # timed alone (CUDA events over a queued window), summed.
        launch_ms = [
            time_cuda(lambda a, kw=kw: bp_kernel.bp_sweep(*a, **kw),
                      lambda a=a: a, warmup=2, runs=21)
            for a, kw in steps_seen
        ]
        kernel_ms = iters * sum(launch_ms)
        banded_launches += launches
        banded_report[str(count)] = dict(
            cross_edges=banded.cross_edges, launches=launches, iters_run=iters,
            partition_seconds=partition_s, sweep_seconds=sweep_s,
            kernel_ms=kernel_ms, launch_ms=launch_ms,
            halo_rows=int(sum(block.halo.size for block in banded.blocks)))
        del banded, got
    report["banded"] = banded_report
    del runs, one_card, captured, idx_host, weights_host

    seconds["b_banded"] = time.perf_counter() - part
    part = time.perf_counter()
    # c. The ring loop at the large-K shape, data made on the card from the
    # seed, against the flat loops on the same inputs: the port's flat
    # cycle loop (the one-pass kernel) and its plain cycle math.
    gen = torch.Generator(device=card).manual_seed(SEED)
    m_k, k_k, steps_k = LARGE_K_MARKETS, LARGE_K_SLOTS, LARGE_K_STEPS
    probs_k = torch.rand((m_k, k_k), generator=gen, device=card)
    mask_k = torch.rand((m_k, k_k), generator=gen, device=card) < 0.9
    outcome_k = torch.rand(m_k, generator=gen, device=card) < 0.5
    tp, tm = probs_k.T.contiguous(), mask_k.T.contiguous()
    now0 = torch.tensor(1.0, device=card)

    def cold_state(shape):
        return MarketBlockState(
            torch.full(shape, 0.5, device=card), torch.full(shape, 0.25, device=card),
            torch.zeros(shape, device=card),
            torch.zeros(shape, dtype=torch.bool, device=card))

    rates = {}
    flat = sharded.build_cycle_loop(card)
    # Each loop's state is made before its clock starts.
    state = cold_state((k_k, m_k))
    (flat_grid, flat_consensus), flat_s = timed_run(lambda: flat(
        ((tp,),), ((tm,),), ((outcome_k,),), ((state,),), 1.0, steps_k))
    rates["flat_loop"] = steps_k / flat_s
    flat_state = flat_grid[0][0]
    plain = make_loop_math(
        lambda *a: _cycle_math(*a, slots_axis=0), steps_k,
        fast_cycle_fn=lambda *a: _fast_cycle_math(*a, slots_axis=0))
    state = cold_state((k_k, m_k))
    (plain_state, plain_consensus), plain_s = timed_run(lambda: plain(
        tp, tm, outcome_k, state, now0))
    rates["plain_flat_loop"] = steps_k / plain_s
    for field, a, b in zip(MarketBlockState._fields, plain_state, flat_state):
        device_bits(a, b, f"large-K plain flat loop {field} vs the kernel's")
    ring_err = {}
    for shape in ((1, 1), (1, 4)):
        name = f"ring_{shape[0]}x{shape[1]}"
        mesh = mesh_module.make_mesh(shape, [card] * shape[1])
        state = cold_state((m_k, k_k))
        grid = tuple(
            tuple(MarketBlockState(*blocks) for blocks in zip(*fields))
            for fields in zip(*(mesh_module.shard_block(f, mesh) for f in state)))
        args = (mesh_module.shard_block(probs_k, mesh),
                mesh_module.shard_block(mask_k, mesh),
                mesh_module.shard_market_vector(outcome_k.cpu().numpy(), mesh))
        loop = ring.build_ring_cycle_loop(mesh)
        (ring_grid, ring_consensus), ring_s = timed_run(
            lambda: loop(*args, grid, 1.0, steps_k))
        rates[name] = steps_k / ring_s
        for f, field in enumerate(MarketBlockState._fields):
            got = mesh_module.unshard_block(
                tuple(tuple(shard[f] for shard in row) for row in ring_grid))
            device_bits(got.T.contiguous(), flat_state[f],
                        f"{name} {field} vs the flat loop")
        ring_err[name] = dict(
            vs_plain=device_close(ring_consensus, plain_consensus, RING_BOUND,
                                  f"{name} consensus"),
            vs_kernel_max_abs=float((ring_consensus - flat_consensus)
                                    .abs().nan_to_num(0.0).max()))
        del ring_grid, ring_consensus, grid, args
    report["ring"] = dict(consensus_err=ring_err)

    seconds["c_ring"] = time.perf_counter() - part
    part = time.perf_counter()
    # d. The compact loop at the same shape, slot-major, against the flat
    # loop's state; its closed form; uint16 probabilities against their
    # decode.
    loop = compact.build_compact_cycle_loop()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    state0 = compact.init_compact_state(m_k, k_k, device=card)
    (c_state, c_consensus), compact_s = timed_run(
        lambda: loop(tp, tm, outcome_k, state0, 1.0, steps_k))
    rates["compact_loop"] = steps_k / compact_s
    compact_peak = torch.cuda.max_memory_allocated() - base
    decoded = compact.compact_to_block(c_state)
    compact_err = {}
    for field in ("reliability", "confidence"):
        compact_err[field] = device_close(
            getattr(decoded, field), getattr(flat_state, field), COMPACT_BOUND,
            f"compact {field} vs the flat loop")
    for field in ("updated_days", "exists"):
        device_bits(getattr(decoded, field), getattr(flat_state, field),
                    f"compact {field} vs the flat loop")
    compact_err["consensus_vs_plain"] = device_close(
        c_consensus, plain_consensus, COMPACT_BOUND, "compact consensus")
    correct = (tp >= 0.5) == outcome_k.unsqueeze(0)
    closed = compact.advance_counters(state0, tm, correct, steps_k, 1.0)
    for field, a, b in zip(compact.CompactBlockState._fields, closed, c_state):
        device_bits(a, b, f"advance_counters {field} vs the loop")
    del correct, closed, decoded
    encoded = compact.encode_probs_u16(tp)
    (u_state, u_consensus), u16_s = timed_run(
        lambda: loop(encoded, tm, outcome_k, state0, 1.0, steps_k))
    rates["compact_u16_probs"] = steps_k / u16_s
    d_state, d_consensus = loop(compact._decode_probs(encoded), tm, outcome_k,
                                state0, 1.0, steps_k)
    device_bits(u_consensus, d_consensus, "u16 consensus vs decoded f32")
    for field, a, b in zip(compact.CompactBlockState._fields, u_state, d_state):
        device_bits(a, b, f"u16 {field} vs decoded f32")
    report["large_k"] = dict(
        markets=m_k, slots=k_k, steps=steps_k,
        cycles_per_second=rates, compact_err=compact_err,
        compact_peak_bytes=compact_peak,
        compact_state_bytes=sum(x.numel() * x.element_size() for x in state0),
        f32_state_bytes=sum(x.numel() * x.element_size() for x in flat_state))
    del (probs_k, mask_k, tp, tm, flat_grid, flat_state, flat_consensus,
         plain_state, plain_consensus, c_state, c_consensus, state0, encoded,
         u_state, u_consensus, d_state, d_consensus)

    seconds["d_compact"] = time.perf_counter() - part
    part = time.perf_counter()
    # The north-star band: one timed compact run, then the float32 state
    # through the flat loop, each with its peak device bytes.
    m_n, k_n, steps_n = NORTH_STAR_MARKETS, NORTH_STAR_SLOTS, NORTH_STAR_STEPS
    probs_n = torch.rand((k_n, m_n), generator=gen, device=card)
    mask_n = torch.rand((k_n, m_n), generator=gen, device=card) < 0.9
    outcome_n = torch.rand(m_n, generator=gen, device=card) < 0.5
    north = {}
    for kind in ("compact", "f32"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        if kind == "compact":
            state = compact.init_compact_state(m_n, k_n, device=card)
            (out_state, out), run_s = timed_run(
                lambda: loop(probs_n, mask_n, outcome_n, state, 1.0, steps_n))
        else:
            state = cold_state((k_n, m_n))
            (out_grid, out), run_s = timed_run(lambda: flat(
                ((probs_n,),), ((mask_n,),), ((outcome_n,),), ((state,),),
                1.0, steps_n))
            out_state = out_grid[0][0]
        settled = int(torch.isfinite(out).sum())
        if settled == 0 or out.shape != (m_n,):
            raise AssertionError(f"north star {kind}: no market settled")
        north[kind] = dict(
            seconds=run_s, cycles_per_second=steps_n / run_s,
            peak_bytes=torch.cuda.max_memory_allocated() - base,
            state_bytes=sum(x.numel() * x.element_size() for x in state),
            settled_markets=settled)
        del state, out_state, out
    report["north_star"] = dict(markets=m_n, slots=k_n, steps=steps_n,
                                input_bytes=probs_n.numel() * 4 + mask_n.numel(),
                                **north)
    del probs_n, mask_n, outcome_n
    seconds["d_north_star"] = time.perf_counter() - part
    shards_launches = sum(
        v for k, v in session_launches.items() if k != "1x1") + banded_launches
    emit("shards", markets=len(market_keys), steps=STEPS, meshes=[
        list(shape) for shape in SHARD_MESHES], band_splits=list(BAND_SPLITS),
         shards_launches=shards_launches, parity_meshes=list(dumps),
         parity_sqlite_bytes=len(dumps["None"]), seconds=seconds,
         nvidia_smi=smi, **report)
    return shards_launches


CLUSTER_NOW = NOW + 100 * STEPS
CLUSTER_RANKS = 2
CLUSTER_ICI = ((1, 1), (1, 2))
CLUSTER_DEVICE = "cuda"
CLUSTER_TIMEOUT_S = 300
# The kill soak: the host route phase's cut of the markets (250,000).
SOAK_ARGS = ("--hosts", "2", "--batches", "12", "--kill-after", "3")

# A rank of phase 22 is the port's rank routine: it joins the gloo group
# and, for each per-rank ici shape, settles ITS band of the batches that
# this process writes it on the card through a band plan and a band
# session: two chained settles, the drifted batch's adopt (held against a
# rebuild from the host) and a third settle. Its consensus and the stored
# values at both plans' slots go to an .npz; its report (seconds,
# launches, peak bytes) is its last line.
RANK_COMMAND = ("-m", "bayesian_consensus_engine_tpu_torch.cluster.rank")


def band_drift(market_keys, counts, codes, rows, band: int):
    """Band *band*'s drifted successor batch: :func:`drifted_batch` over
    its own markets (*rows* of the main path's batch), seeded by the band,
    so that every market stays in the band that owns it; a replaced
    market's key names its band. Returns the band-local ``(keys, codes,
    probs, offsets, outcomes)``."""
    rng = np.random.default_rng((SEED + 2, band))
    starts = np.concatenate([[0], np.cumsum(counts)])
    keys, new_codes, new_probs, new_offsets = drifted_batch(
        rng, market_keys[rows.start:rows.stop], counts[rows.start:rows.stop],
        codes[starts[rows.start]:starts[rows.stop]])
    keys = [key.replace("market-new-", f"market-new-{band}-") for key in keys]
    return (keys, new_codes, new_probs, new_offsets,
            rng.random(len(rows)) < 0.5)


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _package_env() -> dict:
    """This environment with the checkout first on ``PYTHONPATH``."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    return env


def run_ranks(work: str, num_slots: int, band_batches):
    """Phase 22's rank processes, started together, each on its band's
    ``band_batches[rank]``; every rank is killed if any outlasts
    CLUSTER_TIMEOUT_S. Returns the ranks' reports."""
    from bayesian_consensus_engine_tpu_torch.cluster.rank import save_batches

    port = _free_port()
    procs = []
    try:
        for rank, (rows, batches) in enumerate(band_batches):
            path = os.path.join(work, f"batches{rank}.npz")
            save_batches(path, rows, batches)
            job = dict(port=port, rank=rank, ranks=CLUSTER_RANKS,
                       device=CLUSTER_DEVICE, batches=path, markets=MARKETS,
                       num_slots=num_slots, steps=STEPS,
                       now=[CLUSTER_NOW + call * STEPS for call in range(3)],
                       icis=[list(s) for s in CLUSTER_ICI], local=None,
                       timeout_s=CLUSTER_TIMEOUT_S,
                       out=os.path.join(work, f"rank{rank}-%s.npz"))
            procs.append(subprocess.Popen(
                [sys.executable, *RANK_COMMAND, json.dumps(job)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                env=_package_env()))
        deadline = time.time() + CLUSTER_TIMEOUT_S
        outputs = [proc.communicate(timeout=max(1.0, deadline - time.time()))[0]
                   for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    reports = []
    for rank, (proc, out) in enumerate(zip(procs, outputs)):
        if proc.returncode != 0:
            raise AssertionError(f"rank {rank} failed (rc {proc.returncode}):\n"
                                 f"{out[-4000:]}")
        reports.append(json.loads(out.strip().splitlines()[-1]))
    return reports


def cluster_phase(smi, market_keys, codes, probs, offsets, outcomes, counts):
    """Phase 22. Returns the ranks' launches of ``onepass_settle`` and
    ``onepass_partials``."""
    from bayesian_consensus_engine_tpu_torch import pipeline
    from bayesian_consensus_engine_tpu_torch.cluster import MeshView
    from bayesian_consensus_engine_tpu_torch.cluster.rank import (
        FIELDS,
        band_columns,
    )
    from bayesian_consensus_engine_tpu_torch.core.batch import SourceCodes
    from bayesian_consensus_engine_tpu_torch.parallel import mesh as mesh_module
    from bayesian_consensus_engine_tpu_torch.state.tensor_store import (
        TensorReliabilityStore,
    )

    phase_start = time.perf_counter()
    seconds = {}
    table = [f"src-{i}" for i in range(SOURCES)]
    # Each rank's band of the main path's batch and its drifted successor:
    # each band's drift over its own markets; the references adopt the
    # bands' drifts back to back.
    start = time.perf_counter()
    view = MeshView(epoch=0, hosts=tuple(range(CLUSTER_RANKS)))
    whole = (market_keys, SourceCodes(codes, table), probs, offsets, outcomes)
    band_batches, bands = [], []
    for rank in view.hosts:
        rows = view.owned_markets(rank, len(market_keys))
        drift = band_drift(market_keys, counts, codes, rows, rank)
        bands.append(drift)
        band_batches.append((rows, [
            band_columns(whole, rows),
            (drift[0], SourceCodes(drift[1], table), *drift[2:])]))
    second = ([key for band in bands for key in band[0]],
              np.concatenate([band[1] for band in bands]),
              np.concatenate([band[2] for band in bands]),
              np.concatenate([[0]] + [band[3][1:] + base for band, base in zip(
                  bands, np.cumsum([0] + [band[3][-1] for band in bands[:-1]]))]))
    second_outcomes = np.concatenate([band[4] for band in bands])
    del bands
    # One K for both batches, every rank and the references: a band plan
    # is built with the globally agreed num_slots.
    num_slots = int(max(counts.max(), np.diff(second[3]).max()))
    seconds["rank_data"] = time.perf_counter() - start
    work = tempfile.mkdtemp(prefix="chip_smoke_cluster_")

    def references():
        """The one-process sessions on the same card, run after the ranks:
        the one-card session for the ranks' (1, 1) bands, a (1, 2) mesh
        session for their (1, 2) bands; each the ranks' calls on the whole
        axis."""
        out = {}
        for ici in CLUSTER_ICI:
            start = time.perf_counter()
            mesh = (None if ici == (1, 1) else mesh_module.make_mesh(
                ici, [CLUSTER_DEVICE] * (ici[0] * ici[1])))
            store = TensorReliabilityStore()
            plan = pipeline.build_settlement_plan_columnar(
                store, market_keys, SourceCodes(codes, table), probs, offsets,
                num_slots=num_slots)
            session = pipeline.ShardedSettlementSession(store, plan, mesh)
            consensus = [np.asarray(session.settle(
                outcomes, steps=STEPS, now=CLUSTER_NOW + call * STEPS).consensus)
                for call in range(2)]
            plan2 = pipeline.build_settlement_plan_columnar(
                store, second[0], SourceCodes(second[1], table), second[2],
                second[3], num_slots=num_slots)
            served = session.adopt(plan2)
            consensus.append(np.asarray(session.settle(
                second_outcomes, steps=STEPS,
                now=CLUSTER_NOW + 2 * STEPS).consensus))
            session.close()
            if served != "relayout":
                raise AssertionError(f"{ici} reference adopt: {served}")
            out[f"{ici[0]}x{ici[1]}"] = (consensus, store, plan, plan2,
                                         time.perf_counter() - start)
        return out

    try:
        # The ranks alone on the card, then the references: the ranks'
        # seconds carry no other process's work.
        start = time.perf_counter()
        reports = run_ranks(work, num_slots, band_batches)
        seconds["ranks"] = time.perf_counter() - start
        del band_batches
        refs = references()
        checks = {}
        for name, (consensus, store, plan, plan2, ref_s) in refs.items():
            ici = tuple(int(x) for x in name.split("x"))
            start = time.perf_counter()
            for rank, report in enumerate(reports):
                band = report[name]
                what = f"rank {rank} {name}"
                if band["served"] != "relayout" or not all(band["rebuild_equal"]):
                    raise AssertionError(
                        f"{what}: adopt {band['served']}, adopted block equal "
                        f"to a rebuild per field {band['rebuild_equal']}")
                lo, hi = band["rows"]
                got = np.load(os.path.join(work, f"rank{rank}-{name}.npz"))
                for call in range(3):
                    if not np.array_equal(got[f"consensus_{call + 1}"],
                                          consensus[call][lo:hi],
                                          equal_nan=True):
                        raise AssertionError(
                            f"{what}: settle {call + 1}'s consensus is not the "
                            "one-process session's")
                for label, bound in (("plan1", plan), ("plan2", plan2)):
                    slots = bound.slot_rows[:, lo:hi][bound.mask[:, lo:hi]]
                    want = store.host_rows(slots)
                    for field, column in zip(FIELDS, want):
                        if not np.array_equal(got[f"{label}_{field}"], column):
                            raise AssertionError(
                                f"{what}: stored {field} at {label}'s slots "
                                "is not the one-process session's")
                band["launches_expected"] = {
                    "onepass_settle": 3 if ici[1] == 1 else 0,
                    "onepass_partials": 0 if ici[1] == 1 else 3 * ici[1]}
                if band["launches"] != band["launches_expected"]:
                    raise AssertionError(f"{what}: launches {band['launches']}")
            if sum(r[name]["store_rows"] for r in reports) != len(store):
                raise AssertionError(f"{name}: the ranks' stores hold "
                                     "other rows than the reference's")
            checks[name] = dict(reference_rows=len(store), bit_equal=True,
                                reference_s=ref_s,
                                compare_s=time.perf_counter() - start)
        del refs
        seconds["references"] = sum(c["reference_s"] for c in checks.values())
    finally:
        import shutil

        shutil.rmtree(work, ignore_errors=True)

    # (b) the kill soak on the card.
    start = time.perf_counter()
    soak = subprocess.run(
        [sys.executable, "-m", "bayesian_consensus_engine_tpu_torch.cluster.soak",
         *SOAK_ARGS, "--markets", str(HOST_ROUTE_MARKETS),
         "--device", CLUSTER_DEVICE, "--json"],
        capture_output=True, text=True, timeout=CLUSTER_TIMEOUT_S,
        env=_package_env())
    seconds["soak"] = time.perf_counter() - start
    lines = [line for line in soak.stdout.splitlines() if line.startswith("{")]
    if soak.returncode != 0 or not lines:
        raise AssertionError(f"the kill soak failed (rc {soak.returncode}):\n"
                             f"{soak.stdout[-3000:]}\n{soak.stderr[-3000:]}")
    result = json.loads(lines[-1])
    if not (result["ok"] and result["byte_equal_store"]
            and result["byte_equal_sqlite"]
            and result["survivor_journal_self_contained"]):
        raise AssertionError(f"the kill soak's byte coda: {result}")
    launches = {kernel: sum(r[name]["launches"][kernel] for r in reports
                            for name in r if isinstance(r[name], dict))
                for kernel in ("onepass_settle", "onepass_partials")}
    seconds["phase"] = time.perf_counter() - phase_start
    emit("cluster", markets=len(market_keys), ranks=CLUSTER_RANKS,
         icis=[list(s) for s in CLUSTER_ICI], num_slots=num_slots,
         steps=STEPS, launches=launches, checks=checks,
         ranks_report=reports, soak={
             key: result[key] for key in (
                 "ok", "device", "markets", "hosts", "goodput_within_slo",
                 "recovery_s", "adopt_s", "coda_s", "rows_adopted",
                 "dead_journal_tag", "byte_equal_store", "byte_equal_sqlite",
                 "survivor_journal_self_contained", "every_batch_durable",
                 "resident_fallbacks_survivor", "survivor_adopt_modes",
                 "health_transitions_ok", "requests_offered", "slo",
                 "build_s", "wall_s")},
         seconds=seconds, nvidia_smi=smi)
    return launches["onepass_settle"], launches["onepass_partials"]


SURFACE_NOW0 = 600.0  # the surface phase's first day, relative
SURFACE_STAMPS = (0.0, 570.0, 590.0, 599.0)  # cold, then 30, 10, 1 days old
SURFACE_HALF = 10  # the resume's cut: 10 steps, snapshot, 10 more
SURFACE_CHAIN_NOW = NOW + 120 * STEPS  # the kill-resume chain's first day
SURFACE_CHILD_TIMEOUT_S = 300
SURFACE_CHILD_FLAG = "--surface-child"
# The preempted child's command line (the work directory follows).
SURFACE_CHILD = (os.path.abspath(__file__), SURFACE_CHILD_FLAG)
TRACE_EVERY, TRACE_CALLS = 3, 6
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def surface_columns(market_keys, codes, probs, offsets, num_markets):
    """The first *num_markets* markets of the main path's batch as the
    columnar plan's inputs."""
    from bayesian_consensus_engine_tpu_torch.core.batch import SourceCodes

    cut = int(offsets[num_markets])
    table = [f"src-{i}" for i in range(SOURCES)]
    return (market_keys[:num_markets], SourceCodes(codes[:cut], table),
            probs[:cut], offsets[: num_markets + 1])


def surface_chain_settle(store, plan, outcomes, day: int):
    """Day *day* (0, 1, 2) of the kill-resume chain: one flat settle."""
    from bayesian_consensus_engine_tpu_torch import pipeline

    return pipeline.settle(store, plan, outcomes, steps=STEPS,
                           now=SURFACE_CHAIN_NOW + day * STEPS)


def surface_child(work: str) -> int:
    """Phase 23's preempted process: on the host routes' cut of the main
    path's batch, a fresh card store settles two days through the flat C
    route, snapshots itself with ``save_checkpoint`` while the settled
    state is still deferred on the card, writes ``saved`` beside the
    snapshot, and waits to be killed (``SIGKILL``: nothing is synced,
    flushed or closed)."""
    from bayesian_consensus_engine_tpu_torch import pipeline
    from bayesian_consensus_engine_tpu_torch.state.tensor_store import (
        TensorReliabilityStore,
    )

    _counts, codes, probs, offsets, outcomes, market_keys = main_data()
    store = TensorReliabilityStore()
    plan = pipeline.build_settlement_plan_columnar(
        store, *surface_columns(market_keys, codes, probs, offsets,
                                HOST_ROUTE_MARKETS))
    for day in (0, 1):
        surface_chain_settle(store, plan, outcomes[:HOST_ROUTE_MARKETS], day)
    if store._pending is None:
        raise AssertionError("the chain holds no deferred device truth")
    store.save_checkpoint(os.path.join(work, "preempt"))
    with open(os.path.join(work, "saved"), "w", encoding="utf-8") as handle:
        handle.write(json.dumps({"pairs": len(store)}))
    time.sleep(SURFACE_CHILD_TIMEOUT_S)
    return 3  # only reached when nobody killed it


def start_surface_child(work: str):
    log = open(os.path.join(work, "child.log"), "w", encoding="utf-8")
    try:
        proc = subprocess.Popen(
            [sys.executable, *SURFACE_CHILD, work], stdout=log,
            stderr=subprocess.STDOUT, env=_package_env())
    finally:
        log.close()
    return proc


def kill_surface_child(proc, work: str) -> float:
    """Wait for the child's snapshot (at most SURFACE_CHILD_TIMEOUT_S),
    then ``SIGKILL`` it. Returns the seconds from the start of the wait to
    the kill. A child that exits or runs out of time fails the phase."""
    import signal

    start = time.perf_counter()
    marker = os.path.join(work, "saved")
    while not os.path.exists(marker):
        if proc.poll() is not None or \
                time.perf_counter() - start > SURFACE_CHILD_TIMEOUT_S:
            with open(os.path.join(work, "child.log"), encoding="utf-8") as f:
                tail = f.read()[-4000:]
            raise AssertionError(
                f"the preempted child did not snapshot (rc {proc.poll()}):\n"
                f"{tail}")
        time.sleep(0.05)
    waited = time.perf_counter() - start
    os.kill(proc.pid, signal.SIGKILL)
    proc.wait(timeout=60)
    if proc.returncode != -signal.SIGKILL:
        raise AssertionError(f"the child ended with rc {proc.returncode}, "
                             "not by SIGKILL")
    return waited


def trace_device_share(path, label: str, kernel: str) -> dict:
    """From one ``auto_trace`` Chrome trace: its device events, the share
    of the *label* window the card was busy (the union of kernel, copy and
    set events inside it), and *kernel*'s summed device time."""
    with open(path, encoding="utf-8") as handle:
        events = json.load(handle)["traceEvents"]
    names = {event.get("name") for event in events}
    window = [e for e in events if e.get("name") == label
              and e.get("cat") == "user_annotation"]
    device = [e for e in events if e.get("cat") in DEVICE_CATEGORIES
              and e.get("ph") == "X"]
    out = {"labels_present": sorted(n for n in names
                                    if isinstance(n, str) and n.startswith("bce.")),
           "device_events": len(device)}
    if not window or not device:
        return out
    lo = float(window[0]["ts"])
    hi = lo + float(window[0]["dur"])
    spans = sorted((max(lo, float(e["ts"])), min(hi, float(e["ts"]) + float(e["dur"])))
                   for e in device)
    busy, reach = 0.0, lo
    for begin, end in spans:
        begin = max(begin, reach)
        if end > begin:
            busy += end - begin
            reach = end
    out.update(
        window_us=hi - lo, busy_us=busy, busy_share=busy / (hi - lo),
        kernel_events=sum(kernel in e.get("name", "") for e in device),
        kernel_device_ms=sum(float(e["dur"]) for e in device
                             if kernel in e.get("name", "")) / 1e3,
    )
    return out


def surface_phase(smi, market_keys, codes, probs, offsets, outcomes):
    """Phase 23. Returns the phase's launches of ``settle_cycles``,
    ``onepass_settle`` and ``onepass_partials``."""
    from bayesian_consensus_engine_tpu_torch import pipeline
    from bayesian_consensus_engine_tpu_torch.ops import (
        onepass_kernel,
        partials_kernel,
        settle_kernel,
    )
    from bayesian_consensus_engine_tpu_torch.ops.cycle_math import (
        MarketBlockState,
        _cycle_math,
    )
    from bayesian_consensus_engine_tpu_torch.ops.onepass_kernel import (
        OnepassOutputs,
    )
    from bayesian_consensus_engine_tpu_torch import parallel
    from bayesian_consensus_engine_tpu_torch.parallel import sharded
    from bayesian_consensus_engine_tpu_torch.state.checkpoint import (
        CycleCheckpointer,
    )
    from bayesian_consensus_engine_tpu_torch.state.tensor_store import (
        TensorReliabilityStore,
    )
    from bayesian_consensus_engine_tpu_torch.utils.profiling import (
        TRACE_SUFFIX,
        auto_trace,
    )

    seconds = {}
    work = tempfile.mkdtemp(prefix="chip_smoke_surface_")
    child = start_surface_child(work)
    try:
        settle_kernel.LAUNCHES = 0
        onepass_kernel.LAUNCHES = 0
        partials_kernel.LAUNCHES = 0
        card = torch.device("cuda")

        # The main path's (K, M) block and a warm state made from the seed:
        # cold slots and stamps 1, 10 and 30 days before the first day.
        start = time.perf_counter()
        plan_store = TensorReliabilityStore()
        plan = pipeline.build_settlement_plan_columnar(
            plan_store, *surface_columns(market_keys, codes, probs, offsets,
                                         MARKETS))
        del plan_store
        num_slots = int(plan.num_slots)
        rng = np.random.default_rng(SEED + 23)
        shape = (num_slots, MARKETS)
        probs_k = torch.tensor(plan.probs, dtype=torch.float32, device=card)
        mask_k = torch.tensor(plan.mask, device=card)
        outcome = torch.tensor(outcomes, device=card)
        state_k = MarketBlockState(
            torch.tensor(rng.uniform(0.0, 1.0, shape), dtype=torch.float32,
                         device=card),
            torch.tensor(rng.uniform(0.0, 1.0, shape), dtype=torch.float32,
                         device=card),
            torch.tensor(rng.choice(SURFACE_STAMPS, shape), dtype=torch.float32,
                         device=card),
            torch.tensor(rng.random(shape) < 0.7, device=card),
        )
        del plan
        seconds["data"] = time.perf_counter() - start

        def copies(state):
            return MarketBlockState(*(x.clone() for x in state))

        def transposed(state):
            return MarketBlockState(*(x.T.contiguous() for x in state))

        now_t = torch.tensor(SURFACE_NOW0, dtype=torch.float32, device=card)
        errors = {}

        # (a) build_cycle: one partials launch a call, held against the
        # plain cycle math on the card.
        plain = _cycle_math(probs_k, mask_k, outcome, state_k, now_t,
                            slots_axis=0)
        for slot_major in (False, True):
            for donate in (True, False):
                what = (f"build_cycle {'slot' if slot_major else 'market'}"
                        f"-major donate={donate}")
                given = copies(state_k) if slot_major else transposed(state_k)
                before = copies(given)
                blocks = ((probs_k, mask_k) if slot_major else
                          (probs_k.T.contiguous(), mask_k.T.contiguous()))
                launched = partials_kernel.LAUNCHES
                out, took = timed_run(lambda: parallel.build_cycle(
                    donate=donate, slot_major=slot_major)(
                    *blocks, outcome, given, SURFACE_NOW0))
                seconds[what] = took
                if partials_kernel.LAUNCHES - launched != 1:
                    raise AssertionError(f"{what}: {partials_kernel.LAUNCHES - launched} "
                                         "partials launches, expected 1")
                got = out.state if slot_major else transposed(out.state)
                for field, a, b in zip(MarketBlockState._fields, got, plain.state):
                    check_equal(a, b, f"{what} {field}")
                errors[what] = max(
                    check_consensus(a, b, f"{what} {name}") for name, a, b in zip(
                        ("consensus", "confidence", "total_weight"), out[1:],
                        plain[1:]))
                if not donate:
                    for field, a, b in zip(MarketBlockState._fields, given, before):
                        device_bits(a, b, f"{what}: the caller's {field}")
                elif slot_major and given.reliability.is_cuda and \
                        out.state.reliability.data_ptr() != \
                        given.reliability.data_ptr():
                    # On the card the kernel settles the donated block in
                    # place (the plain version, on the CPU, makes new ones).
                    raise AssertionError(f"{what}: the state was not donated")
        del plain

        # (b) build_cycle_loop(slot_major=False, donate=False), 20 steps,
        # against the plain one-pass version (stages off).
        loop = parallel.build_cycle_loop(slot_major=False, donate=False)
        blocks_m = (probs_k.T.contiguous(), mask_k.T.contiguous(), outcome)
        state_m = transposed(state_k)
        before = copies(state_m)
        (full_state, full_consensus), seconds["loop_20"] = timed_run(
            lambda: loop(*blocks_m, state_m, SURFACE_NOW0, STEPS))
        for field, a, b in zip(MarketBlockState._fields, state_m, before):
            device_bits(a, b, f"loop: the caller's {field}")
        want = onepass_kernel.onepass_settle_reference(
            probs_k, mask_k, outcome, state_k, SURFACE_NOW0, STEPS,
            with_tiebreak=False, with_bands=False)
        errors["loop"] = compare_onepass(
            OnepassOutputs(transposed(full_state), full_consensus, None,
                           None, None), want, "build_cycle_loop")
        del want

        # (c) build_cycle_tiebreak_loop on the card's (1, 1) mesh and on a
        # (1, 2) mesh of the card (K padded to 16 slots).
        grid = ((probs_k,),), ((mask_k,),), ((outcome,),)
        (tb_state, tb_consensus, tiebreak), seconds["tiebreak_1x1"] = timed_run(
            lambda: parallel.build_cycle_tiebreak_loop(card, donate=False)(
                *grid, ((copies(state_k),),), SURFACE_NOW0, STEPS))
        want = onepass_kernel.onepass_settle_reference(
            probs_k, mask_k, outcome, state_k, SURFACE_NOW0, STEPS,
            with_tiebreak=True, with_bands=False)
        errors["tiebreak_1x1"] = compare_onepass(
            OnepassOutputs(tb_state[0][0], tb_consensus, tiebreak, None, None),
            want, "tiebreak loop (1, 1)")
        del want
        pad = num_slots % 2

        def padded(x, fill):
            if not pad:
                return x
            return torch.cat([x, torch.full((1, MARKETS), fill, dtype=x.dtype,
                                            device=card)])

        half = (num_slots + pad) // 2
        mesh2 = parallel.make_mesh((1, 2), [card, card])

        def cut(x, fill):
            whole = padded(x, fill)
            return ((whole[:half].contiguous(), whole[half:].contiguous()),)

        state_p = MarketBlockState(
            padded(state_k.reliability, 0.5), padded(state_k.confidence, 0.25),
            padded(state_k.updated_days, 0.0), padded(state_k.exists, False))
        grid2 = (cut(probs_k, 0.0), cut(mask_k, False), ((outcome, outcome),))

        def state_grid():  # fresh copies: the loop settles them in place
            return ((tuple(MarketBlockState(*(f[j * half:(j + 1) * half].clone()
                                               for f in state_p))
                           for j in range(2))),)

        loop2 = parallel.build_cycle_tiebreak_loop(mesh2, donate=True)
        launched = partials_kernel.LAUNCHES
        got2, seconds["tiebreak_1x2"] = timed_run(
            lambda: loop2(*grid2, state_grid(), SURFACE_NOW0, STEPS))
        if partials_kernel.LAUNCHES - launched != 2:
            raise AssertionError("tiebreak loop (1, 2): "
                                 f"{partials_kernel.LAUNCHES - launched} partials "
                                 "launches, expected 2")
        real_partials = sharded.onepass_partials
        sharded.onepass_partials = partials_kernel.onepass_partials_reference
        try:
            want2 = loop2(*grid2, state_grid(), SURFACE_NOW0, STEPS)
        finally:
            sharded.onepass_partials = real_partials
        for j in range(2):
            for field, a, b in zip(MarketBlockState._fields, got2[0][0][j],
                                   want2[0][0][j]):
                check_bits(a, b, f"tiebreak loop (1, 2) shard {j} {field}")
            rows = min(half, num_slots - j * half)  # shard 1 holds the pad
            for field, a, b in zip(MarketBlockState._fields, got2[0][0][j],
                                   tb_state[0][0]):
                check_bits(a[:rows], b[j * half:j * half + rows],
                           f"tiebreak loop (1, 2) shard {j} {field} vs (1, 1)")
        errors["tiebreak_1x2"] = check_consensus(
            got2[1], want2[1], "tiebreak loop (1, 2) consensus")
        for field, a, b in zip(got2[2]._fields, got2[2], want2[2]):
            check_bits(a, b, f"tiebreak loop (1, 2) {field}")
        del got2, want2, state_p, grid2, tb_state, tiebreak

        # (d) resume: 10 steps, a CycleCheckpointer snapshot, a restore onto
        # the card, 10 more: bit-equal to the 20-step run.
        mid_state, _ = loop(*blocks_m, state_m, SURFACE_NOW0, SURFACE_HALF)
        checkpoint = {}
        with CycleCheckpointer(os.path.join(work, "loop")) as ckpt:
            start = time.perf_counter()
            ckpt.save(SURFACE_HALF, mid_state,
                      meta={"next_now": SURFACE_NOW0 + SURFACE_HALF})
            checkpoint["save_sync_s"] = time.perf_counter() - start
            start = time.perf_counter()
            ckpt.wait()
            checkpoint["commit_s"] = time.perf_counter() - start
            step_dir = os.path.join(work, "loop", str(SURFACE_HALF))
            checkpoint["bytes"] = sum(
                os.path.getsize(os.path.join(step_dir, name))
                for name in os.listdir(step_dir))
            start = time.perf_counter()
            restored, meta = ckpt.restore(like=mid_state)
            torch.cuda.synchronize()
            checkpoint["restore_s"] = time.perf_counter() - start
        resumed_state, resumed = loop(*blocks_m, restored, meta["next_now"],
                                      STEPS - SURFACE_HALF)
        for field, a, b in zip(MarketBlockState._fields, resumed_state,
                               full_state):
            device_bits(a, b, f"resumed {field}")
        device_bits(resumed, full_consensus, "resumed consensus")
        del mid_state, restored, resumed_state, full_state

        # (e) profiler: the slot-major loop under auto_trace, every third of
        # six calls captured.
        trace_dir = os.path.join(work, "traces")
        traced = auto_trace(parallel.build_cycle_loop(), trace_dir,
                            every_n=TRACE_EVERY, label="surface")
        carry = copies(state_k)
        start = time.perf_counter()
        for call in range(TRACE_CALLS):
            carry, _ = traced(probs_k, mask_k, outcome, carry,
                              SURFACE_NOW0 + call * STEPS, STEPS)
        torch.cuda.synchronize()
        seconds["traced_calls"] = time.perf_counter() - start
        paths = sorted(name for name in os.listdir(trace_dir)
                       if name.endswith(TRACE_SUFFIX))
        if len(paths) != TRACE_CALLS // TRACE_EVERY:
            raise AssertionError(f"auto_trace wrote {paths}")
        profiler = [trace_device_share(os.path.join(trace_dir, name),
                                       "surface", "onepass_settle")
                    for name in paths]
        for report in profiler:
            if "bce.onepass_settle" not in report["labels_present"]:
                raise AssertionError(f"a trace lacks bce.onepass_settle: {report}")
            if report["device_events"] and report.get("kernel_events") != 1:
                raise AssertionError(f"a trace holds device events but not "
                                     f"one onepass_settle kernel: {report}")
        del carry, state_m, blocks_m

        # (f) kill-resume: the child's snapshot of its deferred chain, a
        # fresh store from it on the card, the third day; the SQLite bytes
        # of an uninterrupted chain.
        columns = surface_columns(market_keys, codes, probs, offsets,
                                  HOST_ROUTE_MARKETS)
        cut_outcomes = outcomes[:HOST_ROUTE_MARKETS]
        start = time.perf_counter()
        straight = TensorReliabilityStore()
        straight_plan = pipeline.build_settlement_plan_columnar(straight, *columns)
        for day in (0, 1, 2):
            expected = surface_chain_settle(straight, straight_plan,
                                            cut_outcomes, day)
        straight.sync()
        straight_db = os.path.join(work, "straight.db")
        straight.flush_to_sqlite(straight_db)
        seconds["straight_chain"] = time.perf_counter() - start
        seconds["child_wait"] = kill_surface_child(child, work)
        start = time.perf_counter()
        snapshot = os.path.join(work, "preempt")
        resumed_store = TensorReliabilityStore.load_checkpoint(snapshot)
        seconds["store_load"] = time.perf_counter() - start
        resumed_plan = pipeline.build_settlement_plan_columnar(
            resumed_store, *columns)
        if not np.array_equal(resumed_plan.slot_rows, straight_plan.slot_rows):
            raise AssertionError("the resumed store bound the plan to other rows")
        day3 = surface_chain_settle(resumed_store, resumed_plan, cut_outcomes, 2)
        resumed_store.sync()
        resumed_db = os.path.join(work, "resumed.db")
        resumed_store.flush_to_sqlite(resumed_db)
        if not np.array_equal(day3.consensus, expected.consensus,
                              equal_nan=True):
            raise AssertionError("the resumed day's consensus differs")
        with open(straight_db, "rb") as a, open(resumed_db, "rb") as b:
            sqlite_bytes = a.read()
            if sqlite_bytes != b.read():
                raise AssertionError("the resumed chain's SQLite bytes differ")
        snapshot_bytes = sum(
            os.path.getsize(os.path.join(root, name))
            for root, _dirs, names in os.walk(snapshot)
            for name in names)
        launches = {"settle_cycles": settle_kernel.LAUNCHES,
                    "onepass_settle": onepass_kernel.LAUNCHES,
                    "onepass_partials": partials_kernel.LAUNCHES}
        expected_launches = {"settle_cycles": 4,
                             "onepass_settle": 1 + 1 + 2 + TRACE_CALLS,
                             "onepass_partials": 4 + 2}
        if launches != expected_launches:
            raise AssertionError(f"launches {launches}, expected "
                                 f"{expected_launches}")
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        shutil.rmtree(work, ignore_errors=True)
    device_events = sum(report["device_events"] for report in profiler)
    emit("surface", markets=MARKETS, slots=num_slots, steps=STEPS,
         now0=SURFACE_NOW0, nvidia_smi=smi, launches=launches,
         max_abs_err=errors, seconds=seconds, checkpoint=checkpoint,
         kill_resume={"markets": HOST_ROUTE_MARKETS,
                      "pairs": len(resumed_store),
                      "snapshot_bytes": snapshot_bytes,
                      "sqlite_bytes": len(sqlite_bytes), "sqlite_equal": True},
         device_events=device_events, profiler=profiler)
    return (launches["settle_cycles"], launches["onepass_settle"],
            launches["onepass_partials"])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from bayesian_consensus_engine_tpu_torch import infer, pipeline
    from bayesian_consensus_engine_tpu_torch.analytics import AnalyticsOptions
    from bayesian_consensus_engine_tpu_torch.core.batch import SourceCodes
    from bayesian_consensus_engine_tpu_torch.ops import (
        bp_kernel,
        cuda_build,
        onepass_kernel,
        partials_kernel,
        settle_kernel,
    )
    from bayesian_consensus_engine_tpu_torch.ops.cycle_math import consensus_merge
    from bayesian_consensus_engine_tpu_torch.ops.tiebreak import ring_tiebreak_math
    from bayesian_consensus_engine_tpu_torch.ops.uncertainty import (
        band_epilogue,
        band_merge,
    )
    from bayesian_consensus_engine_tpu_torch.parallel import mesh as mesh_module
    from bayesian_consensus_engine_tpu_torch.ops.cycle_math import MarketBlockState
    from bayesian_consensus_engine_tpu_torch.parallel import sharded
    from bayesian_consensus_engine_tpu_torch.state.tensor_store import (
        TensorReliabilityStore,
    )

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi, name=kind, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build: one nvcc per source, started together.
    start = time.perf_counter()
    built = cuda_build.build_all()
    # ptxas' figures per source and entry function. No kernel keeps a
    # stack frame or spills: both lanes of the sweep, both dtypes and step
    # counters of the settle kernel, every register-tree depth of the two
    # one-pass kernels (their wider instantiations, "Lin1E", keep the
    # run-time stack tree in local memory and spill nothing).
    ptxas = {source.name: cuda_build.ptxas_report(log)
             for source, (_library, log) in zip(cuda_build.SOURCES, built)}
    # Every entry function must be reported: both lanes of the sweep; each
    # dtype with a 32-bit ("i") and 64-bit ("l") step counter of the settle
    # kernel; each float32 and float64 depth of the one-pass kernels (0 to
    # 6, and -1 mangled "n1").
    depths = [*range(7), "n1"]
    expected = {
        "bp_sweep.cu": [f"bp_sweep_kernelILb{lane}E" for lane in (0, 1)],
        "onepass_settle.cu": [f"onepass_settle_kernelI{t}Li{d}E"
                              for t in "fd" for d in depths],
        "settle_cycles.cu": [f"settle_cycles{lanes}_kernelI{t}{n}E"
                             for lanes in ("", "_lanes")
                             for t in "fd" for n in "il"],
        "onepass_partials.cu": [f"onepass_partials_kernelI{t}Li{d}E"
                                for t in "fd" for d in depths],
    }
    for source, entries in expected.items():
        for entry in entries:
            found = [figures for name, figures in ptxas[source].items()
                     if entry in name and "stack_bytes" in figures]
            if not found:
                raise AssertionError(f"ptxas reported no figures for {entry} "
                                     f"in {source}")
    for name, figures in {name: figures for report in ptxas.values()
                          for name, figures in report.items()}.items():
        if (figures.get("stack_bytes") and "Lin1E" not in name) \
                or figures.get("spill_stores") or figures.get("spill_loads"):
            raise AssertionError(f"ptxas: {name} has a stack frame or spills: "
                                 f"{figures}")
    emit("build", seconds=time.perf_counter() - start,
         libraries=[os.path.relpath(library) for library, _log in built],
         ptxas=[line for _library, log in built for line in log.splitlines()
                if "registers" in line or "spill" in line])

    # 3. kernel_check
    rng = np.random.default_rng(0)
    worst = {}
    cases = 0
    routes = {"staged": 0, "wide": 0}  # tiles, as the kernel reports them
    for dtype, np_dtype in ((torch.float32, np.float32), (torch.float64, np.float64)):
        for num_slots, ragged in ((1, False), (5, False), (15, False),
                                  (16, False), (40, False), (65, False),
                                  (200, False), (200, True)):
            case = random_case(rng, num_slots, 1037, np_dtype, ragged=ragged)
            for steps in (0, 1, 2, 20):
                args = kernel_args(case, dtype, steps, settle_kernel)
                what = f"{dtype} K={num_slots} ragged={ragged} steps={steps}"
                counts = torch.zeros(3, dtype=torch.int32, device="cuda")
                err = compare_kernel(args, settle_kernel, what, routes=counts)
                worst[str(dtype)] = max(worst.get(str(dtype), 0.0), err)
                cases += 1
                staged, wide, _stage = counts.tolist()
                if staged + wide != -(-1037 // 256):
                    raise AssertionError(f"{what}: {staged} + {wide} tiles")
                if ragged and wide != 1:
                    raise AssertionError(
                        f"{what}: the ragged tile did not take the wide route")
                routes["staged"] += staged
                routes["wide"] += wide
    if not (routes["staged"] and routes["wide"]):
        raise AssertionError(f"both routes must run: {routes}")
    emit("kernel_check", cases=cases, markets=1037,
         max_abs_consensus_err=worst, tiles=routes)

    # 4. onepass_check
    rng = np.random.default_rng(1)
    onepass_err = {}
    cases = 0
    stage_sets = {
        torch.float32: [(True, True), (True, False), (False, True), (False, False)],
        torch.float64: [(False, True), (False, False)],
    }
    for dtype, np_dtype in ((torch.float32, np.float32), (torch.float64, np.float64)):
        for num_slots in (1, 5, 16, 17, 33, 40, 64, 65):
            case = block_case(rng, num_slots, 1037, np_dtype, 600.0)

            def t(x, dt=None):
                return torch.tensor(x, dtype=dt, device="cuda")

            for steps in (0, 1, 2, 20):
                for with_tiebreak, with_bands in stage_sets[dtype]:
                    state = MarketBlockState(
                        t(case["rel"], dtype), t(case["conf"], dtype),
                        t(case["days"], dtype), t(case["exists"]),
                    )
                    args = (t(case["probs"], dtype), t(case["mask"]),
                            t(case["outcome"]))
                    stages = dict(with_tiebreak=with_tiebreak, with_bands=with_bands)
                    want = onepass_kernel.onepass_settle_reference(
                        *args, state, 600.0, steps, **stages)
                    clone = MarketBlockState(*(x.clone() for x in state))
                    got = onepass_kernel.onepass_settle(
                        *args, clone, 600.0, steps, **stages)
                    torch.cuda.synchronize()
                    err = compare_onepass(
                        got, want, f"{dtype} K={num_slots} steps={steps} "
                        f"stages={with_tiebreak, with_bands}")
                    onepass_err[str(dtype)] = max(onepass_err.get(str(dtype), 0.0), err)
                    cases += 1
    emit("onepass_check", cases=cases, markets=1037,
         max_abs_consensus_err=onepass_err)

    # 5. bp_check: lanes are (moments, keep_fma).
    rng = np.random.default_rng(2)
    lanes = {"point": (False, None), "point_keep": (False, True),
             "moments": (True, None)}
    cases = 0
    stops = set()
    for degree in (1, 2, 8, 33):
        case = [torch.tensor(x, device="cuda")
                for x in bp_case(rng, 1037, degree)]
        for lane, (moments, keep_fma) in lanes.items():
            args = (case[0], case[1] if moments else None, case[2], case[3])
            sweep = dict(damping=0.3, keep_fma=keep_fma)
            # A tolerance the early exit reaches after 5 or 6 sweeps.
            mid = float(bp_kernel.bp_sweep_reference(
                *args, max_steps=5 + degree % 2, **sweep)[3])
            for tol in (None, 1e-3, mid):
                for max_steps in (1, 2, BP_MAX_STEPS):
                    what = f"bp D={degree} {lane} tol={tol} max_steps={max_steps}"
                    want = bp_kernel.bp_sweep_reference(
                        *args, max_steps=max_steps, tol=tol, **sweep)
                    bp_kernel.LAUNCHES = 0
                    got = bp_kernel.bp_sweep(
                        *args, max_steps=max_steps, tol=tol, **sweep)
                    torch.cuda.synchronize()
                    compare_sweep(got, want, what)
                    if bp_kernel.LAUNCHES != bp_kernel.launches_per_call(max_steps):
                        raise AssertionError(
                            f"{what}: {bp_kernel.LAUNCHES} launches, expected "
                            f"{bp_kernel.launches_per_call(max_steps)}")
                    stops.add(int(got[2]))
                    cases += 1
    emit("bp_check", cases=cases, markets=1037, degrees=[1, 2, 8, 33],
         iters_run_seen=sorted(stops), max_abs_err=0.0)

    # 6. partials_check
    rng = np.random.default_rng(3)
    partials_err = {}
    cases = 0
    for dtype, np_dtype in ((torch.float32, np.float32), (torch.float64, np.float64)):
        for num_slots in PARTIALS_DEPTHS:
            case = partials_case(rng, num_slots, 1037, np_dtype, 600.0)

            def t(x, dt=None):
                return torch.tensor(x, dtype=dt, device="cuda")

            for steps in (0, 1, 2, 20):
                for with_views in (True, False):
                    for with_bands in (True, False):
                        state = MarketBlockState(
                            t(case["rel"], dtype), t(case["conf"], dtype),
                            t(case["days"], dtype), t(case["exists"]),
                        )
                        args = (t(case["probs"], dtype), t(case["mask"]),
                                t(case["outcome"]))
                        stages = dict(with_views=with_views, with_bands=with_bands)
                        want = partials_kernel.onepass_partials_reference(
                            *args, state, 600.0, steps, **stages)
                        clone = MarketBlockState(*(x.clone() for x in state))
                        depth = torch.full((1,), -2, dtype=torch.int32,
                                           device="cuda")
                        got = partials_kernel.onepass_partials(
                            *args, clone, 600.0, steps, depth_out=depth,
                            **stages)
                        torch.cuda.synchronize()
                        what = (f"{dtype} K_loc={num_slots} steps={steps} "
                                f"stages={with_views, with_bands}")
                        err = compare_partials(got, want, what)
                        if int(depth) != PARTIALS_DEPTHS[num_slots]:
                            raise AssertionError(
                                f"{what}: ran the depth-{int(depth)} kernel")
                        partials_err[str(dtype)] = max(
                            partials_err.get(str(dtype), 0.0), err)
                        cases += 1
    emit("partials_check", cases=cases, markets=1037,
         max_abs_sums_err=partials_err)

    # 7. native: the port's C extensions, built from the checkout's sources
    # (the Python twins run only without a compiler or Python.h, or with
    # BCE_NO_NATIVE set; a failing build raises).
    from bayesian_consensus_engine_tpu_torch.native import build as native_build

    native_modules = {name: native_build.load(name)
                      for name in native_build.SOURCES}
    native_report = native_build.report()
    if native_report["compiler"] and native_report["python_h"] \
            and not native_build.native_disabled() and not native_report["built"]:
        raise AssertionError(f"the C extensions did not build: {native_report}")
    internmap = native_modules["internmap"]
    emit("native", **native_report,
         libsqlite3=bool(internmap and internmap.sqlite_writer_available()),
         libraries=[os.path.relpath(module.__file__)
                    for module in native_modules.values() if module])

    # 8. main_path, on the default host route (the C packer, interner and
    # SQLite writer when they built; intern_mode="auto").
    work = tempfile.TemporaryDirectory()
    seconds = {}
    start = time.perf_counter()
    counts, codes, probs, offsets, outcomes, market_keys = main_data()
    sources = SourceCodes(codes, [f"src-{i}" for i in range(SOURCES)])
    seconds["data"] = time.perf_counter() - start

    start = time.perf_counter()
    store = TensorReliabilityStore()
    plan = pipeline.build_settlement_plan_columnar(
        store, market_keys, sources, probs, offsets
    )
    seconds["plan"] = time.perf_counter() - start
    dtype = torch.float32
    # The first settle's inputs, kept for the plain-version check: a copy
    # of the store's cold state, built outside the store's device cache so
    # that the first settle pays its own host-to-device export, as a
    # user's first settle does.
    cold, cold_epoch0 = store._build_device_export(len(store), dtype)
    torch.cuda.synchronize()

    settle_kernel.LAUNCHES = 0
    start = time.perf_counter()
    first = pipeline.settle(store, plan, outcomes, steps=STEPS, now=NOW)
    first.fence()
    seconds["settle_1"] = time.perf_counter() - start
    # The second settle's inputs: the settled state the store hands
    # forward to the chained settle, copied between the timed windows.
    pending, warm_epoch0 = store._pending
    warm = [x.clone() for x in pending]
    torch.cuda.synchronize()
    start = time.perf_counter()
    second = pipeline.settle(store, plan, outcomes, steps=STEPS, now=NOW + STEPS)
    second.fence()
    seconds["settle_2"] = time.perf_counter() - start
    start = time.perf_counter()
    consensus_2 = second.consensus
    consensus_1 = first.consensus
    seconds["fetch"] = time.perf_counter() - start
    start = time.perf_counter()
    store.sync()
    seconds["sync"] = time.perf_counter() - start
    main_db = os.path.join(work.name, "settled.db")
    start = time.perf_counter()
    flushed = store.flush_to_sqlite(main_db)
    seconds["flush"] = time.perf_counter() - start
    launches = settle_kernel.LAUNCHES

    if launches != 2:
        raise AssertionError(f"{launches} kernel launches for 2 settles")
    if flushed != len(store):
        raise AssertionError(f"flushed {flushed} rows of {len(store)}")
    for values in (consensus_1, consensus_2):
        if values.shape != (MARKETS,) or not np.all(np.isfinite(values)):
            raise AssertionError("consensus is not finite of shape (M,)")
    if warm_epoch0 != cold_epoch0:
        raise AssertionError(f"epoch moved: {cold_epoch0} -> {warm_epoch0}")
    touched_rows, touched_offsets = settle_kernel.touched_layout(
        plan.slot_rows, plan.mask
    )
    block = (
        torch.tensor(plan.slot_rows, device="cuda"),
        torch.tensor(plan.probs, dtype=dtype, device="cuda"),
        torch.tensor(plan.mask, device="cuda"),
        torch.tensor(outcomes, device="cuda"),
        torch.tensor(touched_offsets, device="cuda"),
        len(touched_rows),
    )
    cold_args = (*cold, *block, float(np.float32(NOW - cold_epoch0)), STEPS)
    warm_args = (
        *warm, *block, float(np.float32(NOW + STEPS - warm_epoch0)), STEPS
    )
    # Each settle against the plain version on the inputs it was given; the
    # first settle's whole state (what the second one consumed) bit-equal.
    plain_1 = settle_kernel.settle_cycles_reference(*cold_args)
    used = len(store)
    for got, want, what in zip(warm, plain_1[:4], ("reliability", "confidence",
                                                  "updated_days", "exists")):
        check_equal(got[:used], want[:used], f"main path settle 1 {what}")
    main_err = check_consensus(
        torch.from_numpy(consensus_1), plain_1.consensus, "main path consensus 1"
    )
    del plain_1
    plain_2 = settle_kernel.settle_cycles_reference(*warm_args)
    main_err = max(main_err, check_consensus(
        torch.from_numpy(consensus_2), plain_2.consensus, "main path consensus 2"
    ))
    del plain_2
    emit("main_path", markets=MARKETS, pairs=len(store),
         slots=int(plan.num_slots), steps=STEPS, launches=launches,
         flushed_rows=flushed, max_abs_consensus_err=main_err,
         seconds=seconds, cut=None, interner=type(store._pairs).__name__,
         intern_stats=plan.intern_stats,
         peak_device_bytes=torch.cuda.max_memory_allocated())

    # 9. host_routes: the first HOST_ROUTE_MARKETS markets of the same data
    # through the default (C) route and the Python route (native=False
    # under BCE_NO_NATIVE=1: the dict interner, the numpy grouping, the
    # sqlite3 module), each on a fresh store through the same two settles,
    # sync and flush. The plans' rows, the consensus and the checkpoints'
    # ordered rows must be equal; then a full iterdump() comparison of the
    # two routes on a DUMP_MARKETS cut.
    def python_route(run):
        previous = os.environ.get("BCE_NO_NATIVE")
        os.environ["BCE_NO_NATIVE"] = "1"
        try:
            return run()
        finally:
            if previous is None:
                del os.environ["BCE_NO_NATIVE"]
            else:
                os.environ["BCE_NO_NATIVE"] = previous

    route_cut = int(offsets[HOST_ROUTE_MARKETS])
    route_columns = (market_keys[:HOST_ROUTE_MARKETS],
                     SourceCodes(codes[:route_cut], sources.table),
                     probs[:route_cut], offsets[: HOST_ROUTE_MARKETS + 1])

    def drive_route(route, native):
        timings = {}
        settle_kernel.LAUNCHES = 0
        start = time.perf_counter()
        route_store = TensorReliabilityStore()
        route_plan = pipeline.build_settlement_plan_columnar(
            route_store, *route_columns, native=native)
        timings["plan"] = time.perf_counter() - start
        results = []
        for step, now in enumerate((NOW, NOW + STEPS), 1):
            start = time.perf_counter()
            results.append(pipeline.settle(
                route_store, route_plan, outcomes[:HOST_ROUTE_MARKETS],
                steps=STEPS, now=now))
            results[-1].fence()
            timings[f"settle_{step}"] = time.perf_counter() - start
        start = time.perf_counter()
        route_store.sync()
        timings["sync"] = time.perf_counter() - start
        path = os.path.join(work.name, f"route-{route}.db")
        start = time.perf_counter()
        written = route_store.flush_to_sqlite(path)
        timings["flush"] = time.perf_counter() - start
        sort_seconds = None
        if hasattr(route_store._pairs, "sorted_rows"):
            start = time.perf_counter()
            route_store._pairs.sorted_rows(
                np.arange(len(route_store), dtype=np.int32))
            sort_seconds = time.perf_counter() - start
        timings["flush_sort"] = sort_seconds
        return (timings, route_plan, [r.consensus for r in results], written,
                type(route_store._pairs).__name__, settle_kernel.LAUNCHES,
                path)

    routes = {"native": drive_route("native", None),
              "python": python_route(lambda: drive_route("python", False))}
    interners = {name: route[4] for name, route in routes.items()}
    route_launches = {name: route[5] for name, route in routes.items()}
    if interners["python"] != "IdInterner" or \
            set(route_launches.values()) != {2}:
        raise AssertionError(f"host routes: {interners}, launches "
                             f"{route_launches} for 2 settles each")
    if not np.array_equal(routes["python"][1].slot_rows,
                          routes["native"][1].slot_rows):
        raise AssertionError("the two routes' plans differ in slot_rows")
    for got, want in zip(routes["python"][2], routes["native"][2]):
        if not np.array_equal(got, want, equal_nan=True):
            raise AssertionError("the two routes' consensus differs")
    digests = {name: table_digest(route[6]) for name, route in routes.items()}
    route_rows = {name: route[3] for name, route in routes.items()}
    route_seconds = {name: route[0] for name, route in routes.items()}
    if len(set(route_rows.values())) != 1 or \
            digests["native"] != digests["python"]:
        raise AssertionError(f"the two routes' checkpoints differ: "
                             f"{route_rows} rows, {digests}")
    del routes
    cut = offsets[DUMP_MARKETS]
    dumps = {}

    def dump_route(route, native):
        small = TensorReliabilityStore()
        small_plan = pipeline.build_settlement_plan_columnar(
            small, market_keys[:DUMP_MARKETS],
            SourceCodes(codes[:cut], sources.table),
            probs[:cut], offsets[: DUMP_MARKETS + 1], native=native,
        )
        for now in (NOW, NOW + STEPS):
            pipeline.settle(small, small_plan, outcomes[:DUMP_MARKETS],
                            steps=STEPS, now=now)
        path = os.path.join(work.name, f"cut-{route}.db")
        small.flush_to_sqlite(path)
        return dump_lines(path)

    dumps["native"] = dump_route("native", None)
    dumps["python"] = python_route(lambda: dump_route("python", False))
    if dumps["native"] != dumps["python"]:
        raise AssertionError("the two routes' iterdump() differ on the cut")
    emit("host_routes", markets=HOST_ROUTE_MARKETS,
         seconds={"main_path_native": {"plan": seconds["plan"],
                                       "flush": seconds["flush"]},
                  **route_seconds},
         interners=interners, launches=route_launches, slot_rows_equal=True,
         sqlite_rows=route_rows["native"], sqlite_sha256=digests["native"],
         dump_markets=DUMP_MARKETS, dump_lines=len(dumps["native"]))
    del dumps

    # 10. delta_check: a drifting second batch bound with intern_mode="auto"
    # and "full" on twin stores, both having bound the main path's batch
    # first: equal rows, equal checkpoints after a settle of each plan, the
    # delta route's matched pairs, and a re-bind that hits the fingerprint.
    # On the host routes' cut of the markets (DELTA_MARKETS).
    delta_rng = np.random.default_rng(SEED + 2)
    delta_cut = int(offsets[DELTA_MARKETS])
    second = drifted_batch(delta_rng, market_keys[:DELTA_MARKETS],
                           counts[:DELTA_MARKETS], codes[:delta_cut])
    second_outcomes = delta_rng.random(DELTA_MARKETS) < 0.5
    batches = ((market_keys[:DELTA_MARKETS],
                SourceCodes(codes[:delta_cut], sources.table),
                probs[:delta_cut], offsets[:DELTA_MARKETS + 1]),
               (second[0], SourceCodes(second[1], sources.table), second[2],
                second[3]))
    delta_seconds, delta_plans, delta_digests = {}, {}, {}
    settle_kernel.LAUNCHES = 0
    for mode in ("auto", "full"):
        twin = TensorReliabilityStore()
        delta_plans[mode] = []
        for number, batch in enumerate(batches, 1):
            start = time.perf_counter()
            staged = pipeline.stage_settlement_plan_columnar(
                *batch, intern_mode=mode)
            delta_seconds[f"{mode}_stage_{number}"] = time.perf_counter() - start
            start = time.perf_counter()
            delta_plans[mode].append(staged.bind(twin))
            delta_seconds[f"{mode}_bind_{number}"] = time.perf_counter() - start
        if mode == "auto":
            start = time.perf_counter()
            rebound = pipeline.stage_settlement_plan_columnar(
                *batches[1], intern_mode="auto").bind(twin)
            delta_seconds["auto_rebind_2"] = time.perf_counter() - start
        for bound, batch_outcomes, now in zip(
                delta_plans[mode], (outcomes[:DELTA_MARKETS], second_outcomes),
                (NOW, NOW + 2)):
            pipeline.settle(twin, bound, batch_outcomes, steps=2, now=now).fence()
        twin.sync()
        path = os.path.join(work.name, f"delta-{mode}.db")
        twin.flush_to_sqlite(path)
        delta_digests[mode] = table_digest(path)
        del twin
    delta_launches = settle_kernel.LAUNCHES
    stats = delta_plans["auto"][1].intern_stats
    for got, want in zip(delta_plans["auto"], delta_plans["full"]):
        if not np.array_equal(got.slot_rows, want.slot_rows):
            raise AssertionError("delta and full interning gave other rows")
    if not np.array_equal(rebound.slot_rows, delta_plans["auto"][1].slot_rows):
        raise AssertionError("the re-bound batch resolved to other rows")
    if delta_digests["auto"] != delta_digests["full"]:
        raise AssertionError(f"delta and full checkpoints differ: {delta_digests}")
    if stats["mode"] != "delta" or stats["matched_pairs"] <= 0 \
            or stats["fingerprint_hit"] \
            or not rebound.intern_stats["fingerprint_hit"] \
            or delta_launches != 4:
        raise AssertionError(f"delta stats {stats}, re-bind "
                             f"{rebound.intern_stats}, {delta_launches} launches")
    emit("delta_check", markets=DELTA_MARKETS, replaced=REPLACED, redrawn=REDRAWN,
         stats=stats, full_stats=delta_plans["full"][1].intern_stats,
         rebind_stats=rebound.intern_stats, launches=delta_launches,
         seconds=delta_seconds, sqlite_sha256=delta_digests["auto"])
    del delta_plans, rebound, second, batches
    # The main path's checkpoint stays for the journal phase (16).
    for name in os.listdir(work.name):
        if not name.startswith("settled.db"):
            os.remove(os.path.join(work.name, name))

    # 11. analytics_path: the main path's plan and store through a resident
    # session. Each one-pass call's inputs are copied as the loop hands
    # them to the kernel (the kernel updates the state in place), so that
    # the plain version can be run on them afterwards; the copies are made
    # inside the timed calls.
    captured = []
    real_onepass = sharded.onepass_settle

    def capturing(probs, mask, outcome, state, now0, steps, **stages):
        before = MarketBlockState(*(x.clone() for x in state))
        out = real_onepass(probs, mask, outcome, state, now0, steps, **stages)
        torch.cuda.synchronize()
        captured.append(((probs, mask, outcome, before, now0, steps), stages,
                         clone_outputs(out)))
        return out

    analytics_seconds = {}
    launch_counts = []
    calls = []
    sharded.onepass_settle = capturing
    try:
        onepass_kernel.LAUNCHES = 0
        settle_kernel.LAUNCHES = 0
        start = time.perf_counter()
        session = pipeline.ShardedSettlementSession(store, plan)
        analytics_seconds["open"] = time.perf_counter() - start
        for call, now in enumerate((NOW + 2 * STEPS, NOW + 3 * STEPS), 1):
            start = time.perf_counter()
            result, tiebreak, bands, propagated = session.settle_with_analytics(
                outcomes, steps=STEPS, now=now, analytics=AnalyticsOptions(),
            )
            result.fence()
            analytics_seconds[f"call_{call}"] = time.perf_counter() - start
            launch_counts.append(onepass_kernel.LAUNCHES)
            calls.append((result, tiebreak, bands, propagated))
        start = time.perf_counter()
        session.close()
        analytics_seconds["close"] = time.perf_counter() - start
    finally:
        sharded.onepass_settle = real_onepass
    onepass_launches = onepass_kernel.LAUNCHES
    if launch_counts != [1, 2] or settle_kernel.LAUNCHES != 0:
        raise AssertionError(
            f"one-pass launches after each call {launch_counts}, settle "
            f"kernel launches {settle_kernel.LAUNCHES}: expected [1, 2] and 0"
        )
    if store.live_row_count() != len(store):
        raise AssertionError("a settled row does not exist after close")
    onepass_main_err = 0.0
    for call, ((inputs, stages, got), (result, tiebreak, bands, propagated)) in enumerate(
        zip(captured, calls), 1
    ):
        want = onepass_kernel.onepass_settle_reference(*inputs, **stages)
        onepass_main_err = max(onepass_main_err, compare_onepass(
            got, want, f"analytics call {call}"))
        del want
        consensus = result.consensus
        if consensus.shape != (MARKETS,) or not np.all(np.isfinite(consensus)):
            raise AssertionError("analytics consensus is not finite of shape (M,)")
        for name, values in zip(tiebreak._fields + bands._fields,
                                tuple(tiebreak) + tuple(bands)):
            if np.asarray(values).shape != (MARKETS,):
                raise AssertionError(f"analytics {name} is not of shape (M,)")
        lo, hi = np.asarray(bands.lo), np.asarray(bands.hi)
        if not (np.all((0 <= lo) & (lo <= hi) & (hi <= 1)) and propagated is None):
            raise AssertionError("bands outside [0, 1] or out of order")
        if not np.array_equal(consensus, got.consensus.cpu().numpy()):
            raise AssertionError("session consensus differs from the kernel's")

    # Analytics on/off byte parity: the same 20,000 markets settled flat,
    # through a session, and through a session with analytics.
    cut = offsets[PARITY_MARKETS]
    parity_dumps, parity_consensus = [], []
    with tempfile.TemporaryDirectory() as tmp:
        for mode in ("flat", "session", "analytics"):
            small = TensorReliabilityStore()
            small_plan = pipeline.build_settlement_plan_columnar(
                small, market_keys[:PARITY_MARKETS],
                SourceCodes(codes[:cut], sources.table),
                probs[:cut], offsets[: PARITY_MARKETS + 1],
            )
            small_outcomes = outcomes[:PARITY_MARKETS]
            results = []
            if mode == "flat":
                for now in (NOW, NOW + STEPS):
                    results.append(pipeline.settle(
                        small, small_plan, small_outcomes, steps=STEPS, now=now))
            else:
                with pipeline.ShardedSettlementSession(small, small_plan) as s:
                    for now in (NOW, NOW + STEPS):
                        if mode == "session":
                            results.append(s.settle(
                                small_outcomes, steps=STEPS, now=now))
                        else:
                            results.append(s.settle_with_analytics(
                                small_outcomes, steps=STEPS, now=now)[0])
            parity_consensus.append([r.consensus for r in results])
            path = os.path.join(tmp, f"{mode}.db")
            small.flush_to_sqlite(path)
            with open(path, "rb") as handle:
                parity_dumps.append(handle.read())
    if not all(dump == parity_dumps[0] for dump in parity_dumps):
        raise AssertionError("SQLite bytes differ between flat, session and "
                             "analytics settles")
    for values in parity_consensus[1:]:
        for got, want in zip(values, parity_consensus[0]):
            if not np.array_equal(got, want, equal_nan=True):
                raise AssertionError("consensus differs with analytics on")
    emit("analytics_path", markets=MARKETS, slots=int(plan.num_slots),
         steps=STEPS, calls=len(calls), launches=onepass_launches,
         max_abs_consensus_err=onepass_main_err, seconds=analytics_seconds,
         parity_markets=PARITY_MARKETS, parity_sqlite_bytes=len(parity_dumps[0]),
         peak_device_bytes=torch.cuda.max_memory_allocated())

    # 12. inference_path: the same plan and store through a session with a
    # real graph. Each sweep's seeds and outputs are copied as the loop
    # hands them to the kernel, so that the plain version can be run on
    # them afterwards; the copies are made inside the timed calls.
    inference_seconds = {}
    start = time.perf_counter()
    blocks, edges = inference_graph(market_keys, SEED + 1, infer)
    graph = blocks.to_graph(extra_edges=edges)
    del edges
    inference_seconds["graph_build"] = time.perf_counter() - start
    options = AnalyticsOptions(
        graph=graph, blocks=blocks,
        inference=infer.InferenceOptions(tol=BP_TOL, max_steps=BP_MAX_STEPS),
    )
    bp_captured = []
    real_bp = sharded.bp_sweep

    def capturing_bp(means, variances, neighbor_idx, neighbor_w, **sweep):
        seeds = (means.clone(), None if variances is None else variances.clone(),
                 neighbor_idx, neighbor_w)
        out = real_bp(means, variances, neighbor_idx, neighbor_w, **sweep)
        torch.cuda.synchronize()
        bp_captured.append((seeds, sweep, tuple(
            None if x is None else x.clone() for x in out)))
        return out

    session_cls = pipeline.ShardedSettlementSession
    real_blocks, real_project = session_cls._graph_blocks, session_cls._project_blocks

    def timed(method, name):
        def run(self, *args):
            begin = time.perf_counter()
            out = method(self, *args)
            torch.cuda.synchronize()
            key = f"{name}_{sum(k.startswith(name) for k in inference_seconds) + 1}"
            inference_seconds[key] = time.perf_counter() - begin
            return out
        return run

    bp_counts, block_caches, inference_calls = [], [], []
    sharded.bp_sweep = capturing_bp
    session_cls._graph_blocks = timed(real_blocks, "align")
    session_cls._project_blocks = timed(real_project, "project")
    try:
        bp_kernel.LAUNCHES = 0
        onepass_kernel.LAUNCHES = 0
        settle_kernel.LAUNCHES = 0
        session = pipeline.ShardedSettlementSession(store, plan)
        for call, now in enumerate((NOW + 4 * STEPS, NOW + 5 * STEPS), 1):
            start = time.perf_counter()
            result, _tb, bands, propagated = session.settle_with_analytics(
                outcomes, steps=STEPS, now=now, analytics=options,
            )
            result.fence()
            inference_seconds[f"call_{call}"] = time.perf_counter() - start
            bp_counts.append(bp_kernel.LAUNCHES)
            block_caches.append(session._graph_cache[2])
            inference_calls.append(propagated)
        start = time.perf_counter()
        session.close()
        inference_seconds["close"] = time.perf_counter() - start
    finally:
        sharded.bp_sweep = real_bp
        session_cls._graph_blocks, session_cls._project_blocks = (
            real_blocks, real_project)
    bp_launches = bp_kernel.LAUNCHES
    per_call = bp_kernel.launches_per_call(BP_MAX_STEPS)
    if bp_counts != [per_call, 2 * per_call] or onepass_kernel.LAUNCHES != 2 \
            or settle_kernel.LAUNCHES != 0:
        raise AssertionError(
            f"bp_sweep launches after each call {bp_counts} (expected "
            f"{[per_call, 2 * per_call]}), one-pass {onepass_kernel.LAUNCHES} "
            f"(expected 2), settle {settle_kernel.LAUNCHES} (expected 0)")
    if block_caches[0] is not block_caches[1]:
        raise AssertionError("the second call aligned the graph again")
    degree = int(block_caches[0][0].shape[1])
    iters_run, bp_err, projected_events = [], 0.0, 0
    for call, ((seeds, sweep, got), propagated) in enumerate(
        zip(bp_captured, inference_calls), 1
    ):
        want = bp_kernel.bp_sweep_reference(*seeds, **sweep)
        compare_sweep(got, want, f"inference call {call}")
        finite = torch.isfinite(want[0])
        bp_err = max(bp_err, float((got[0] - want[0])[finite].abs().max()))
        iters_run.append(int(got[2]))
        stderr = torch.sqrt(want[1].double()).to(torch.float32)
        mean_p, stderr_p = blocks.project(
            market_keys, want[0].cpu().numpy(), stderr.cpu().numpy())
        check_bits(torch.from_numpy(np.asarray(propagated.mean)),
                   torch.from_numpy(mean_p), f"inference call {call} projected mean")
        check_bits(torch.from_numpy(np.asarray(propagated.stderr)),
                   torch.from_numpy(stderr_p), f"inference call {call} projected stderr")
        if int(propagated.iters_run) != int(want[2]):
            raise AssertionError(f"inference call {call}: iters_run differs")
        events = mean_p.reshape(-1, EVENT_SIZE).astype(np.float64)
        if not np.all(np.isfinite(events)) or np.any(
            np.abs(events.sum(axis=1) - 1.0) > 1e-6
        ):
            raise AssertionError(f"inference call {call}: a partition does "
                                 "not sum to 1 within 1e-6")
        projected_events = events.shape[0]
    del want

    # Graph on/off byte parity: the same 20,000 markets through a session
    # with the graph and one without.
    small_keys = market_keys[:PARITY_MARKETS]
    small_blocks, small_edges = inference_graph(small_keys, SEED + 2, infer)
    small_options = AnalyticsOptions(
        graph=small_blocks.to_graph(extra_edges=small_edges), blocks=small_blocks,
        inference=infer.InferenceOptions(tol=BP_TOL, max_steps=BP_MAX_STEPS),
    )
    graph_dumps, graph_consensus = [], []
    with tempfile.TemporaryDirectory() as tmp:
        for mode in ("off", "graph"):
            small = TensorReliabilityStore()
            small_plan = pipeline.build_settlement_plan_columnar(
                small, small_keys, SourceCodes(codes[:cut], sources.table),
                probs[:cut], offsets[: PARITY_MARKETS + 1],
            )
            values = []
            with pipeline.ShardedSettlementSession(small, small_plan) as s:
                for now in (NOW, NOW + STEPS):
                    out = s.settle_with_analytics(
                        outcomes[:PARITY_MARKETS], steps=STEPS, now=now,
                        analytics=small_options if mode == "graph" else None)
                    if (out[3] is None) != (mode == "off"):
                        raise AssertionError(f"parity {mode}: propagated slot")
                    values.append(out[0].consensus)
            graph_consensus.append(values)
            path = os.path.join(tmp, f"{mode}.db")
            small.flush_to_sqlite(path)
            with open(path, "rb") as handle:
                graph_dumps.append(handle.read())
    if graph_dumps[0] != graph_dumps[1]:
        raise AssertionError("SQLite bytes differ with the graph on and off")
    for got, want in zip(*graph_consensus):
        if not np.array_equal(got, want, equal_nan=True):
            raise AssertionError("consensus differs with the graph on")
    emit("inference_path", markets=MARKETS, events=projected_events,
         edges=graph.num_edges, degree=degree, steps=STEPS,
         max_steps=BP_MAX_STEPS, tol=BP_TOL, calls=len(inference_calls),
         iters_run=iters_run, launches=bp_launches,
         launches_per_call=per_call, max_abs_err=bp_err,
         seconds=inference_seconds, parity_markets=PARITY_MARKETS,
         parity_sqlite_bytes=len(graph_dumps[0]),
         peak_device_bytes=torch.cuda.max_memory_allocated())

    # 13. sharded_path: the main path's plan and store through a session on
    # a (1, 4) mesh of the one card. Each partials launch's inputs are
    # copied as the loop hands them to the kernel (it updates the state in
    # place), and its outputs after it, so that the plain version can be
    # run on them afterwards; the copies are made inside the timed calls.
    cuda0 = torch.device("cuda", torch.cuda.current_device())
    sharded_seconds = {}
    partials_captured = []
    real_partials = sharded.onepass_partials

    def capturing_partials(probs, mask, outcome, state, now0, steps, **stages):
        before = MarketBlockState(*(x.clone() for x in state))
        out = real_partials(probs, mask, outcome, state, now0, steps, **stages)
        torch.cuda.synchronize()
        partials_captured.append((
            (probs, mask, outcome, before, now0, steps), stages,
            type(out)(MarketBlockState(*(x.clone() for x in out.state)),
                      *(None if x is None else x.clone() for x in out[1:])),
        ))
        return out

    mesh = mesh_module.make_mesh((1, 4), [cuda0] * 4)
    partials_counts, sharded_calls = [], []
    sharded.onepass_partials = capturing_partials
    try:
        partials_kernel.LAUNCHES = 0
        onepass_kernel.LAUNCHES = 0
        settle_kernel.LAUNCHES = 0
        bp_kernel.LAUNCHES = 0
        start = time.perf_counter()
        session = pipeline.ShardedSettlementSession(store, plan, mesh)
        sharded_seconds["open"] = time.perf_counter() - start
        for call, now in enumerate((NOW + 6 * STEPS, NOW + 7 * STEPS), 1):
            start = time.perf_counter()
            out = session.settle_with_analytics(
                outcomes, steps=STEPS, now=now, analytics=AnalyticsOptions(),
            )
            out[0].fence()
            sharded_seconds[f"call_{call}"] = time.perf_counter() - start
            partials_counts.append(partials_kernel.LAUNCHES)
            sharded_calls.append((out, [
                mesh_module.unshard_slot_block(
                    [[getattr(shard, field) for shard in row]
                     for row in session._state]).clone()
                for field in MarketBlockState._fields
            ]))
        start = time.perf_counter()
        session.close()
        sharded_seconds["close"] = time.perf_counter() - start
    finally:
        sharded.onepass_partials = real_partials
    partials_launches = partials_kernel.LAUNCHES
    if partials_counts != [4, 8] or onepass_kernel.LAUNCHES != 0 \
            or settle_kernel.LAUNCHES != 0 or bp_kernel.LAUNCHES != 0:
        raise AssertionError(
            f"partials launches after each call {partials_counts} (expected "
            f"[4, 8]), one-pass {onepass_kernel.LAUNCHES}, settle "
            f"{settle_kernel.LAUNCHES}, bp_sweep {bp_kernel.LAUNCHES} "
            "(expected 0)")
    if store.live_row_count() != len(store):
        raise AssertionError("a settled row does not exist after close")
    # Each launch against the plain version on that shard's inputs.
    sharded_err = 0.0
    for n, (inputs, stages, got) in enumerate(partials_captured):
        want = partials_kernel.onepass_partials_reference(*inputs, **stages)
        sharded_err = max(sharded_err, compare_partials(
            got, want, f"sharded call {n // 4 + 1} shard {n % 4}"))
        del want
    # Each call against one onepass_settle launch on its inputs unsharded:
    # state and bands bit-equal, consensus within tolerance.
    num_slots = plan.num_slots
    k_loc = int(partials_captured[0][0][0].shape[0])
    if k_loc & (k_loc - 1):
        raise AssertionError(
            f"K_loc = {k_loc} is not a power of two: the shards' band trees "
            "would not be subtrees of the one-card tree")
    for call, (out, state_after) in enumerate(sharded_calls, 1):
        shards = partials_captured[4 * (call - 1): 4 * call]

        def whole(pick):
            return torch.cat([pick(inputs) for inputs, _, _ in shards], dim=0)

        before = [whole(lambda x, i=i: x[3][i]) for i in range(4)]
        one = onepass_kernel.onepass_settle(
            whole(lambda x: x[0])[:num_slots].contiguous(),
            whole(lambda x: x[1])[:num_slots].contiguous(), shards[0][0][2],
            MarketBlockState(*(x[:num_slots].contiguous() for x in before)),
            shards[0][0][4], STEPS,
        )
        torch.cuda.synchronize()
        for field, got, want, old in zip(MarketBlockState._fields, state_after,
                                         one.state, before):
            check_bits(got[:num_slots], want,
                       f"sharded call {call} {field} vs one card")
            check_bits(got[num_slots:], old[num_slots:],
                       f"sharded call {call} pad slots' {field}")
        merged_bands = band_epilogue(one.band_sums, one.band_count)
        for field, values in zip(merged_bands._fields, out[2]):
            check_bits(torch.from_numpy(np.asarray(values)),
                       getattr(merged_bands, field).cpu(),
                       f"sharded call {call} bands.{field} vs one card")
        sharded_err = max(sharded_err, check_consensus(
            torch.from_numpy(out[0].consensus), one.consensus.cpu(),
            f"sharded call {call} consensus vs one card"))
        for name, values in zip(out[1]._fields, out[1]):
            if np.asarray(values).shape != (MARKETS,):
                raise AssertionError(f"sharded {name} is not of shape (M,)")
        del one, before

    # Mesh byte parity: the same 20,000 markets through the one-card
    # session and sessions on three meshes of the card.
    mesh_dumps = {}
    with tempfile.TemporaryDirectory() as tmp:
        for shape in (None, (1, 2), (1, 4), (2, 2)):
            small = TensorReliabilityStore()
            small_plan = pipeline.build_settlement_plan_columnar(
                small, market_keys[:PARITY_MARKETS],
                SourceCodes(codes[:cut], sources.table),
                probs[:cut], offsets[: PARITY_MARKETS + 1],
            )
            small_mesh = None if shape is None else mesh_module.make_mesh(
                shape, [cuda0] * (shape[0] * shape[1]))
            with pipeline.ShardedSettlementSession(small, small_plan, small_mesh) as s:
                for now in (NOW, NOW + STEPS):
                    s.settle_with_analytics(
                        outcomes[:PARITY_MARKETS], steps=STEPS, now=now)
            path = os.path.join(tmp, f"{shape}.db")
            small.flush_to_sqlite(path)
            with open(path, "rb") as handle:
                mesh_dumps[str(shape)] = handle.read()
    if len(set(mesh_dumps.values())) != 1:
        raise AssertionError("SQLite bytes differ between the one-card session "
                             f"and the meshes: {list(mesh_dumps)}")

    # One (1, 4) call with a graph: bp_sweep runs on the merged consensus.
    graph_captured = []

    def capturing_graph_bp(means, variances, neighbor_idx, neighbor_w, **sweep):
        seeds = (means.clone(), None if variances is None else variances.clone(),
                 neighbor_idx, neighbor_w)
        out = real_bp(means, variances, neighbor_idx, neighbor_w, **sweep)
        torch.cuda.synchronize()
        graph_captured.append((seeds, sweep, tuple(
            None if x is None else x.clone() for x in out)))
        return out

    small = TensorReliabilityStore()
    small_plan = pipeline.build_settlement_plan_columnar(
        small, small_keys, SourceCodes(codes[:cut], sources.table),
        probs[:cut], offsets[: PARITY_MARKETS + 1],
    )
    sharded.bp_sweep = capturing_graph_bp
    try:
        bp_kernel.LAUNCHES = 0
        partials_kernel.LAUNCHES = 0
        onepass_kernel.LAUNCHES = 0
        settle_kernel.LAUNCHES = 0
        with pipeline.ShardedSettlementSession(small, small_plan, mesh) as s:
            graph_out = s.settle_with_analytics(
                outcomes[:PARITY_MARKETS], steps=STEPS, now=NOW,
                analytics=small_options)
        graph_launches = bp_kernel.LAUNCHES
        graph_partials = partials_kernel.LAUNCHES
        graph_other = onepass_kernel.LAUNCHES + settle_kernel.LAUNCHES
    finally:
        sharded.bp_sweep = real_bp
    if graph_launches != per_call or len(graph_captured) != 1 \
            or graph_partials != 4 or graph_other != 0:
        raise AssertionError(
            f"graph call: {graph_launches} bp_sweep launches (expected "
            f"{per_call}), {graph_partials} partials (expected 4), "
            f"{graph_other} one-pass or settle (expected 0)")
    seeds, sweep, got = graph_captured[0]
    check_bits(seeds[0].cpu(), torch.from_numpy(
        np.asarray(graph_out[0].consensus).astype(np.float32)),
        "graph seeds vs the merged consensus")
    compare_sweep(got, bp_kernel.bp_sweep_reference(*seeds, **sweep),
                  "sharded graph sweep")
    emit("sharded_path", markets=MARKETS, mesh=[1, 4], slots=int(num_slots),
         padded_slots=int(-(-num_slots // 4) * 4), steps=STEPS,
         calls=len(sharded_calls), launches=partials_launches,
         max_abs_err=sharded_err, seconds=sharded_seconds,
         parity_markets=PARITY_MARKETS, parity_meshes=list(mesh_dumps),
         parity_sqlite_bytes=len(mesh_dumps["None"]),
         graph_launches=graph_launches,
         peak_device_bytes=torch.cuda.max_memory_allocated())

    # 14. kernels: each kernel and its plain version timed on its path's
    # inputs (fresh clones each run, so every run does the same work). The
    # chained (warm) settle, where every row exists and is read, is the
    # steady state and the headline; the first (cold) settle reads no
    # stored state and turns every row on.
    num_touched = len(touched_rows)
    touched_d = torch.tensor(touched_rows, dtype=torch.int64, device="cuda")
    timings = {}
    err = 0.0
    for name, args in (("cold", cold_args), ("warm", warm_args)):
        err = max(err, compare_kernel(args, settle_kernel, f"main-path {name}"))

        def prepare(args=args):
            return [a.clone() if isinstance(a, torch.Tensor) else a for a in args]

        kernel_ms = time_cuda(
            lambda a: settle_kernel.settle_cycles(*a), prepare, warmup=3, runs=21
        )
        plain_ms, plain_paced_by = time_window(
            lambda a: settle_kernel.settle_cycles_reference(*a), prepare,
            warmup=1, runs=5,
        )
        num_existing = int(args[3][touched_d].sum())
        bound = settle_kernel.bound_bytes(
            plan.num_slots, MARKETS, num_touched, num_existing, STEPS, 4
        )
        timings[name] = dict(
            kernel_ms=kernel_ms, plain_ms=plain_ms,
            plain_paced_by=plain_paced_by, bound_bytes=bound,
            bound_ms=bound / HBM_BYTES_PER_S * 1e3, existing_rows=num_existing,
        )
    warm_t, cold_t = timings["warm"], timings["cold"]
    # The chained launch at steps=1: what the step loop adds to the memory
    # traffic, without a profiler.
    one_step_ms = time_cuda(
        lambda a: settle_kernel.settle_cycles(*a),
        lambda: [a.clone() if isinstance(a, torch.Tensor) else a
                 for a in warm_args[:-1]] + [1],
        warmup=3, runs=21,
    )
    # The chained launch once more, asking the kernel for its route report.
    routes = torch.zeros(3, dtype=torch.int32, device="cuda")
    settle_kernel.settle_cycles(
        *[a.clone() if isinstance(a, torch.Tensor) else a for a in warm_args],
        routes=routes)
    staged_tiles, wide_tiles, stage_slots = routes.tolist()
    settle_entry = {
        "name": "settle_cycles",
        "route": "cuda",
        "source": "bayesian_consensus_engine_tpu_torch/csrc/settle_cycles.cu",
        "replaces": "bayesian_consensus_engine_tpu/ops/pallas_cycle.py:95",
        "launches": launches,
        "max_abs_err": err,
        # "ms" is the harness's key and "kernel_ms" the same time under
        # the name the port's records use: the chained settle's.
        "ms": warm_t["kernel_ms"],
        "kernel_ms": warm_t["kernel_ms"],
        "plain_ms": warm_t["plain_ms"],
        "plain_paced_by": warm_t["plain_paced_by"],
        "bound_ms": warm_t["bound_ms"],
        "bound_by": "bytes",
        "bound_bytes": warm_t["bound_bytes"],
        "library_ms": None,
        "cold": {key: cold_t[key] for key in (
            "kernel_ms", "plain_ms", "plain_paced_by", "bound_ms",
            "bound_bytes")},
        "one_step_ms": one_step_ms,
        # The kernel's own report of that launch: the stage's slots and its
        # tiles of 256 markets by route.
        "stage_slots": stage_slots,
        "tiles": staged_tiles + wide_tiles,
        "wide_tiles": wide_tiles,
        # ptxas' figures of the instantiations a settle of fewer than 2^31
        # steps takes (32-bit step counter), float32 and float64.
        "ptxas": {dt: next((figures for name, figures
                            in ptxas["settle_cycles.cu"].items()
                            if f"settle_cycles_kernelI{code}iE" in name), None)
                  for dt, code in (("float32", "f"), ("float64", "d"))},
    }
    # onepass_settle on the chained analytics call's inputs: every row
    # exists, and the state is read, settled 20 steps and written in place.
    inputs, stages, _got = captured[1]

    def prepare_onepass():
        probs_d, mask_d, outcome_d, state, now0, steps = inputs
        return (probs_d, mask_d, outcome_d,
                MarketBlockState(*(x.clone() for x in state)), now0, steps)

    onepass_ms = time_cuda(
        lambda a: onepass_kernel.onepass_settle(*a, **stages), prepare_onepass,
        warmup=3, runs=21,
    )
    onepass_plain_ms, onepass_plain_paced_by = time_window(
        lambda a: onepass_kernel.onepass_settle_reference(*a, **stages),
        prepare_onepass, warmup=1, runs=5,
    )
    # The same launch with both analytics stages off, and with one of them
    # on: what the tie-break and the bands each add to the settle.
    stage_ms = {}
    for label, tiebreak_on, bands_on in (("stages_off_ms", False, False),
                                         ("tiebreak_only_ms", True, False),
                                         ("bands_only_ms", False, True)):
        only = dict(stages, with_tiebreak=tiebreak_on, with_bands=bands_on)
        stage_ms[label] = time_cuda(
            lambda a, only=only: onepass_kernel.onepass_settle(*a, **only),
            prepare_onepass, warmup=3, runs=21,
        )
    mask_d, state = inputs[1], inputs[3]
    depth = max(int(mask_d.shape[0]) - 1, 0).bit_length()
    onepass_bound = onepass_kernel.bound_bytes(
        plan.num_slots, MARKETS, int(mask_d.sum()),
        int((state.exists & mask_d).sum()), STEPS, 4,
    )
    onepass_entry = {
        "name": "onepass_settle",
        "route": "cuda",
        "source": "bayesian_consensus_engine_tpu_torch/csrc/onepass_settle.cu",
        "replaces": "bayesian_consensus_engine_tpu/ops/pallas_settle.py:133",
        "launches": onepass_launches,
        "max_abs_err": onepass_main_err,
        "ms": onepass_ms,
        "kernel_ms": onepass_ms,
        "plain_ms": onepass_plain_ms,
        "plain_paced_by": onepass_plain_paced_by,
        "bound_ms": onepass_bound / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "bound_bytes": onepass_bound,
        "library_ms": None,
        **stage_ms,
        "launches_per_call": 1,
        # ptxas' figures of the float32 instantiation the path's K takes:
        # band-tree depth log2(pow2_at_least(K)).
        "band_tree_depth": depth,
        "ptxas": next((figures for name, figures
                       in ptxas["onepass_settle.cu"].items()
                       if f"onepass_settle_kernelIfLi{depth}E" in name), None),
    }
    # bp_sweep on the chained inference call's seeds; the kernel leaves its
    # inputs untouched, so every run takes the same ones.
    seeds, sweep, chained = bp_captured[1]
    bp_ms = time_cuda(lambda a: bp_kernel.bp_sweep(*a, **sweep), lambda: seeds,
                      warmup=3, runs=21)
    bp_plain_ms, bp_plain_paced_by = time_window(
        lambda a: bp_kernel.bp_sweep_reference(*a, **sweep), lambda: seeds,
        warmup=1, runs=3)
    bp_iters = int(chained[2])
    bp_bound = bp_kernel.bound_bytes(MARKETS, degree, bp_iters, True)
    bp_entry = {
        "name": "bp_sweep",
        "route": "cuda",
        "source": "bayesian_consensus_engine_tpu_torch/csrc/bp_sweep.cu",
        "replaces": "bayesian_consensus_engine_tpu/ops/pallas_bp.py:109",
        "launches": bp_launches,
        "max_abs_err": bp_err,
        "ms": bp_ms,
        "kernel_ms": bp_ms,
        "plain_ms": bp_plain_ms,
        "plain_paced_by": bp_plain_paced_by,
        "bound_ms": bp_bound / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "bound_bytes": bp_bound,
        "library_ms": None,
        "iters_run": bp_iters,
        "launches_per_call": per_call,
        "ptxas": {("moments" if "ILb1E" in name else "point"): figures
                  for name, figures in ptxas["bp_sweep.cu"].items()} or None,
    }
    # onepass_partials on the sharded path's chained call: its 4 launches
    # (one a shard), each on fresh copies of that shard's state.
    chained_shards = partials_captured[4:8]

    def prepare_partials():
        return [(probs_d, mask_d, outcome_d,
                 MarketBlockState(*(x.clone() for x in state)), now0, steps)
                for (probs_d, mask_d, outcome_d, state, now0, steps), _, _
                in chained_shards]

    shard_stages = chained_shards[0][1]

    def run_shards(fn):
        return lambda shard_args: [fn(*a, **shard_stages) for a in shard_args]

    partials_ms = time_cuda(run_shards(partials_kernel.onepass_partials),
                            prepare_partials, warmup=3, runs=21)
    partials_plain_ms, partials_plain_paced_by = time_window(
        run_shards(partials_kernel.onepass_partials_reference),
        prepare_partials, warmup=1, runs=5)
    # The cross-shard merge in eager PyTorch on the chained call's partials,
    # as the loop runs it: the sharded tie-break, band_merge + band_epilogue
    # and the consensus psums + epilogue.
    parts = [got for _, _, got in chained_shards]
    shard_inputs = [inputs for inputs, _, _ in chained_shards]

    def merge(_unused):
        ring_tiebreak_math(
            [x[0] for x in shard_inputs], [p.read_rel for p in parts],
            [p.read_conf for p in parts], [p.read_rel for p in parts],
            [x[1] for x in shard_inputs], axis_size=4, device=cuda0,
            agents_last=False, chunk_agents=1024,
        )
        band_epilogue(*band_merge([p.band_sums for p in parts],
                                  [p.band_count for p in parts], cuda0))
        consensus_merge([p.consensus_sums for p in parts], cuda0)

    merge_ms, merge_paced_by = time_window(merge, lambda: None, warmup=2,
                                           runs=11)
    # The same launches with the views and bands off: the settle alone.
    partials_off_ms = time_cuda(
        lambda shard_args: [partials_kernel.onepass_partials(
            *a, with_views=False, with_bands=False) for a in shard_args],
        prepare_partials, warmup=3, runs=21)
    # Shard 0's launch once more, asking the kernel which instantiation
    # (band-tree depth) it runs.
    depth_d = torch.full((1,), -2, dtype=torch.int32, device="cuda")
    first_shard = prepare_partials()[0]
    partials_kernel.onepass_partials(*first_shard, **shard_stages,
                                     depth_out=depth_d)
    partials_depth = int(depth_d)
    partials_code = f"Li{partials_depth}E" if partials_depth >= 0 else "Lin1E"
    partials_bound = sum(
        partials_kernel.bound_bytes(
            int(probs_d.shape[0]), MARKETS, int(mask_d.sum()),
            int((state.exists & mask_d).sum()), int(state.exists.sum()),
            steps, 4, with_views=shard_stages["with_views"],
            with_bands=shard_stages["with_bands"])
        for (probs_d, mask_d, _o, state, _n, steps), _, _ in chained_shards
    )
    partials_entry = {
        "name": "onepass_partials",
        "route": "cuda",
        "source": "bayesian_consensus_engine_tpu_torch/csrc/onepass_partials.cu",
        "replaces": "bayesian_consensus_engine_tpu/ops/pallas_settle.py:349",
        "launches": partials_launches,
        "max_abs_err": sharded_err,
        # One session call's work: its 4 launches, one a sources shard.
        "ms": partials_ms,
        "kernel_ms": partials_ms,
        "kernel_ms_per_launch": partials_ms / 4,
        "plain_ms": partials_plain_ms,
        "plain_paced_by": partials_plain_paced_by,
        "bound_ms": partials_bound / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "bound_bytes": partials_bound,
        "library_ms": None,
        "stages_off_ms": partials_off_ms,
        "merge_ms": merge_ms,
        "merge_paced_by": merge_paced_by,
        "launches_per_call": 4,
        # The depth the kernel reported for the path's K_loc, and ptxas'
        # figures of that instantiation, float32 and float64.
        "band_tree_depth": partials_depth,
        "ptxas": {dt: next((figures for name, figures
                            in ptxas["onepass_partials.cu"].items()
                            if f"onepass_partials_kernelI{code}{partials_code}"
                            in name), None)
                  for dt, code in (("float32", "f"), ("float64", "d"))},
    }

    # 15. batch_consensus
    batch_consensus_phase(smi, market_keys, codes, probs, offsets)

    # 16. journal
    settle_entry["journal_launches"] = journal_phase(
        smi, store, market_keys, codes, probs, offsets, outcomes, main_db,
        work.name)
    work.cleanup()

    # 17. stream
    del store
    (settle_entry["stream_launches"], onepass_entry["stream_launches"],
     stream_trace, stream_digest) = stream_phase(
        smi, market_keys, codes, probs, offsets, outcomes)

    # 18. serve
    settle_entry["serve_launches"], onepass_entry["serve_launches"] = (
        serve_phase(smi, market_keys, codes, probs, offsets, outcomes))

    # 19. analytics_rest
    partials_entry["analytics_rest_launches"] = analytics_rest_phase(
        smi, market_keys, codes, probs, offsets, outcomes)

    # 20. replay
    lanes_entry, settle_entry["replay_launches"] = replay_phase(
        smi, stream_trace, stream_digest, ptxas)
    del stream_trace

    # 21. shards
    bp_entry["shards_launches"] = shards_phase(
        smi, market_keys, codes, probs, offsets, outcomes, graph)

    # 22. cluster
    onepass_entry["cluster_launches"], partials_entry["cluster_launches"] = (
        cluster_phase(smi, market_keys, codes, probs, offsets, outcomes,
                      counts))

    # 23. surface
    (settle_entry["surface_launches"], onepass_entry["surface_launches"],
     partials_entry["surface_launches"]) = surface_phase(
        smi, market_keys, codes, probs, offsets, outcomes)

    print(json.dumps({"kernels": [settle_entry, onepass_entry, bp_entry,
                                  partials_entry, lanes_entry]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == SURFACE_CHILD_FLAG:
        sys.exit(surface_child(sys.argv[2]))
    sys.exit(main())
