#!/usr/bin/env python3
"""Card-side smoke of the PyTorch port (spark_rapids_ml_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which exits non-zero on a failed check:

1. The card (``nvidia-smi`` name and power limit), torch/CUDA/nvcc
   versions, and the build of every ``ops/csrc/*.cu`` with nvcc for sm_90a
   (one nvcc per source, all started together).
2. Each kernel against its plain PyTorch version on the card, at ragged
   shapes (tolerances stated beside each check), the LogisticRegression
   pair included. First the newest routes: ``dist_topk`` on both routes
   (its shared-memory plan against knn.cu's, then bitwise on small-integer
   rows at nq in {1, 63, 128, 129, 4,101}, m in {k, 255, 256, 257,
   70,001}, d in {8, 64, 768, 1,000}, k in {1, 10, the route's limit, 64},
   masked rows, three valid rows, duplicated rows under permuted ids;
   f32 and d = 12 on the FFMA tiles) and ``probe_select`` on both routes
   (the fused body's shared memory against knn.cu's, then bitwise at nlist
   in {1, 37, 1,024, 4,099}, nprobe in {1, 20, nlist}, q in {1, 129,
   4,096}); then the tensor-core
   ``ivf_scan_select`` (its shared-memory plan against knn.cu's, then
   bitwise on small-integer residuals at maxlen in {1, 7, 64, 255, 256,
   2049}, C in {1, 63, 208}, blk_k in {1, 12, the route's limit}, d in {8,
   768, 1000}, a list with three valid rows, duplicated rows; then its
   FFMA route), and ``gram`` on both SYRK bodies (bitwise at d in {8,
   136, 1000, 2048, 13, 300}, with and without a mask, the seeded FFMA
   modes into non-symmetric states; gaussian rows against float64). Then
   the tensor-core route of ``gram_colsum`` and
   ``linreg_stats`` (bf16, d % 8 == 0): bitwise on small-integer inputs at
   d in {8, 1000, 2048}, n ragged across stages and splits, n_valid in
   {0, 1, 1234, n, n + 5}, seeded non-symmetric states, a {0, 1} mask and
   every promotion interval; then at tolerance on gaussian rows. Then the
   weighted tensor-core route: ``softmax_curvature`` bitwise on
   small-integer rows with dyadic weights (p in {0, 1/4, 1/2, 1}) at d in
   {8, 1000, 1024}, C in {1, 3, 32}, masked and not, every promotion
   interval; ``newton_stats`` against an emulation of its own rounding
   (1e-5) and its plain version (2⁻⁸ of Σ|terms| for the Hessian, 1e-5
   for the rest). d = 300 and 13, and float32, must take the FFMA route.
   ``python3 chip_smoke.py --phase2`` stops after this phase;
   ``--data-plane`` runs phases 19 to 22, phase 23's Spark part and phase
   25 alone after the build; ``--estimators`` runs phases 23 and 24 alone;
   ``--multi-process`` runs phase 26 alone; ``--multi-daemon`` runs
   phase 27 alone; ``--elastic`` runs phase 28 alone; ``--serving`` runs
   phase 29 alone; ``--telemetry`` runs phase 30 alone; ``--fleet`` runs
   phases 31 and 32 alone; ``--model-axis`` runs phase 33 alone;
   ``--analyze`` runs phase 34 alone.
3. The PCA streaming fit at full width (d=2048, k=32, bf16 batches of
   262,144 rows) through ``fit_pca_stream``; the ``gram_colsum`` launches
   must equal the batch count, all on the tensor-core route; components
   checked sign-invariantly against a float64 Gram of the same batches
   computed on the card.
4. The in-memory ``PCA().fit`` of 1,048,576 x 2048 rows (four batches'
   worth, so one launch sums far more rows than a batch) through the
   ``gram`` kernel: at the default dtype (bf16 on the card: one
   ``gram/wgmma`` launch, checked against float64 of the bf16-rounded
   rows) and forced to float32 (one ``gram/ffma`` launch), with the same
   check; the wall time of each.
5. PCA transform of 65,536 rows against a float64 product; its p50 latency.
6. The PCA kernels timed at the main path's shape beside their plain
   versions, their bounds and the ``torch.matmul`` yardstick, and the Gram
   error of the kernel and of the plain version against a float64 Gram;
   the tensor-core ``gram_colsum`` at each promotion interval (time and
   error against float64); ``gram`` on both routes at 1,048,576 x 2048,
   bf16 against the bf16 ``torch.matmul`` and f32 against cuBLAS SGEMM,
   the f32 route's error no worse than the plain version's.
7. KMeans at full width (BASELINE.json config #3: d=256, k=100) on
   16,764,871 bf16 rows of 100 unequal gaussian blobs: ``fit_kmeans``
   (k-means++, maxIter 20, tol 1e-4); ``lloyd_step`` launches must equal
   the iterations and ``assign_min_dist`` must launch once; the centres
   must be a fixed point of Lloyd's map in float64 and the cost must match
   a float64 recomputation.
8. ``fit_kmeans_stream`` over 8 float32 batches of 262,144 rows of the same
   blobs, against ``fit_kmeans`` on their concatenation from the same
   initial centres.
9. LinearRegression at width 1024: the streaming fold of 8 bf16 batches of
   262,144 rows (``linreg_stats`` launches must equal the batches, all on
   the tensor-core route) and an elastic-net finalize, then the in-memory
   ``LinearRegression().fit`` of 1,048,576 x 1024 float32 rows (one launch,
   FFMA route), each against float64 solves of the same normal equations
   on the card.
10. The KMeans and LinearRegression kernels timed at their main paths'
    shapes, as in phase 6, with the ``linreg_stats`` Gram error of the
    kernel and the plain version against float64.
11. Binomial LogisticRegression at full width (bench_logreg.py: d=1024,
    511,943 = 2^19 − 12,345 bf16 rows, regParam 1e-4, Spark's maxIter 100
    and tol 1e-6) through ``LogisticRegression().fit``: ``newton_stats``
    launches must equal ``summary.numIter``, all on the tensor-core route;
    coefficients against a float64 Newton fit of the same bf16 rows on the
    card, and the float64 objective at the port's solution against the
    float64 optimum; a trace of a second fit.
12. Multinomial LogisticRegression at full width (d=1024, C=32, 129,838
    float32 rows; regParam 1e-4, five MM-Newton passes at tol 0):
    ``softmax_curvature`` launches must equal 5, all on the tensor-core
    route; the objective must not increase from pass to pass; (W, b)
    against the same five passes in float64 on the card (gradient on the
    float32 rows, curvature on the bf16-rounded rows with the operand
    rounded as the fit's route rounds it; the distance to the passes with
    the unrounded operand is printed); one pass's statistics at the final
    iterate against float64; a trace of a second fit.
13. LogisticRegressionModel.transform_matrix on 65,536 x 1024 rows, binary
    and multinomial: rawPrediction and probability against float64,
    predictions equal off near-ties; p50 latency of 21 runs.
14. The LogisticRegression kernels timed at the phase 11 and 12 shapes, as
    in phase 6: the Newton row pass and Gram pass apart (a trace), the
    FFMA body on the same rows and the unweighted tensor-core
    ``gram_colsum`` at the same shapes beside them, and each kernel's
    promotion sweep against float64 of its own rounding; the Newton solve
    of the (d + 1) system.
15. The nearest-neighbour kernels against their plain versions at the
    path's shapes: ``dist_topk`` at the exact query's shape and at the IVF
    build's spill-candidate shape; ``probe_select`` and ``ivf_scan_select``
    on the inputs captured from the phase-17 query. Ids must agree wherever
    the plain version's gap to the next value exceeds the stated tolerance.
16. Exact ``NearestNeighbors`` on bench_knn.py's data (BASELINE.json config
    #5 cut to one chip: 1,048,576 x 768 rows of a 4,096-component gaussian
    mixture, spread 0.35), bf16 compute, 4,096 queries, k = 10: one
    ``dist_topk`` launch per kneighbors, on the tensor-core route, q/s, and
    the answer against float64 distances of the same bf16-rounded rows.
17. ``ApproximateNearestNeighbors`` (nlist 1,024, nprobe 20, k 10, slack
    1.5): the build's seconds, maxlen and kernel launches (its f32
    ``dist_topk`` spill candidates on the FFMA route); kneighbors q/s and
    recall@10 against float64 ground truth with ``ann_rerank`` on and off
    (one ``probe_select`` launch per call on the fused route and one
    ``ivf_scan_select`` on the tensor-core route) and the call's device
    breakdown; then every list probed (its probe on the sort route), where
    recall@10 must reach 0.98.
18. The three nearest-neighbour kernels timed at those shapes beside their
    plain versions, bounds and the library route (``torch.matmul`` or
    ``torch.bmm`` plus a stable top-k; for ``dist_topk`` also matmul plus
    ``torch.topk``, a time yardstick with no tie order), ``dist_topk`` and
    ``probe_select`` each on both routes.
19. The PCA data plane: the port's ``DataPlaneDaemon`` in this process on
    the card and 8 partition tasks, each with its own ``DataPlaneClient``,
    sending 2 ``feed_raw`` batches of 65,536 x 2048 float32 rows (Spark's
    maxRecordsPerBatch; 512 MiB a frame; bf16-exact rows) and committing:
    1,048,576 rows. Partition 0's attempt 0 feeds one batch and is
    abandoned, one feed is re-sent with its feed_id, one commit is sent
    twice; ``status`` must read 1,048,576 rows and ``gram_colsum`` must
    launch once per folded feed (17), all on the tensor-core route. The
    k = 32 finalize over the wire against float64 PCA of the same rows
    (phase 3's tolerances) and against the in-process ``fit_pca_stream``
    of the same batches; ``ensure_model`` over the wire, then the served
    transform of 65,536 rows through the daemon's registry, bitwise equal
    to ``PCAModel.transform_matrix``. It prints the data-plane rows/s
    beside the in-process stream's, the daemon's spans (frame receive and
    decode, host to device, fold, commit, eigh finalize), the run's device
    time from a torch.profiler trace, the fold kernel alone at the feed's
    shape (CUDA events), and the registry transform's p50.
20. The Spark PCA fit's feed protocol from separate processes: the port's
    daemon in this process on the card and 8 forked task processes, each
    building its own bf16-exact numpy rows from its seed (phase 19's
    shape: 2 feeds of 65,536 x 2048 float32) and, once all are ready and
    the clock runs, the Spark feed task's body
    (``spark/estimator._feed_partition``) with a ``feed_raw`` sender;
    partition 3's attempt 0 dies after one feed and its attempt 1 wins.
    This process plays the driver with the estimator's own code: the
    acks' row accounting, the finalize with the split-brain row guard and
    ``pass_rows_expected``, the ``PCAModel`` build. Acked, ``status`` and
    finalize rows must be 1,048,576 and ``gram_colsum`` must launch once
    per folded feed (17), all on the tensor-core route; the components
    are held to float64 of the same rows (phase 3's tolerances) and to the
    in-process ``fit_pca_stream`` of them (1e-5), both rebuilt here from
    the tasks' seeds. It prints rows/s beside phase 19's, the daemon's
    span split and the device busy share. (Arrow ``feed`` and
    ``mapInArrow`` need pyarrow, which this machine lacks; they run in the
    CPU tests.)
21. The iterative daemon jobs through the Spark feed protocol: the port's
    daemon in this process on the card, 8 task processes forked once and
    reused by every pass, each building its bf16-exact (x, y) float32
    frames from its seed and running ``_feed_partition`` with a
    ``feed_raw`` sender; partition 3's attempt 0 dies after one feed in
    each fit's first scan. This process runs the estimators' own driver
    functions (``spark/estimator._drive_linreg``, ``_drive_logreg``,
    ``_drive_kmeans``) over those passes. LinearRegression d = 1024 on
    1,048,576 rows (8 x 2 frames of 65,536): ``linreg_stats`` launches once
    per folded feed (17), all on the tensor-core route. Multinomial
    LogisticRegression C = 32, d = 1024, 131,072 rows (8 x 16,384), five
    MM passes at tol 0: ``softmax_curvature`` launches once per folded feed
    (41), all wgmma. Binomial LogisticRegression d = 1024 on 524,288 rows,
    five Newton passes, and KMeans d = 256, k = 100 on 1,048,576 blob rows
    (seeded by ``seed`` from a 3,200-row prefix, maxIter 20, tol 1e-4, then
    the cost scan): no kernel, as in the reference's daemon. Acked,
    ``status`` and finalize rows must agree; each model is held to the
    port's in-process stream fit of the same frames (linreg, both logregs)
    or to a float64 Lloyd from the same seeded centres (kmeans, with every
    assignment and count equal to float64's), with the tolerance beside
    each check; each served predict through ``ensure_model`` is bitwise
    equal to ``transform_matrix``. It prints rows/s and ms per pass of each
    fit, the daemon's span split and the device busy share.
22. The knn job through the Spark feed protocol: the port's daemon in this
    process on the card, 8 task processes forked once and reused by both
    fits, each building its float32 frames of bench_knn.py's mixture from
    its seed (2 ``feed_raw`` frames of 65,536 x 768: 1,048,576 rows at
    config #5's width) and running ``_feed_partition``; partition 3's
    attempt 0 dies after one feed in each fit. This process runs
    ``spark/estimator._drive_knn`` twice: exact ``NearestNeighbors`` (k =
    10) and ``ApproximateNearestNeighbors`` (k = 10, nlist 1,024, nprobe
    20), each finalize building the index on the daemon and registering
    it. Acked, ``status`` and finalize rows must be 1,048,576. Exact: no
    kernel at the build; 4,096 queries through ``_DaemonKNNModel.kneighbors``
    (raw frames), one ``dist_topk`` launch a call on the tensor-core route;
    the ids equal the in-process ``NearestNeighborsModel``'s over the same
    rows in partition-major order, the distances within 1e-6 relative, and
    both are held to float64 brute force as in phase 16. IVF: the build's
    launches as the in-process build's (10 ``lloyd_step`` on the
    tensor-core route, ``assign_min_dist``'s f32 chunks on FFMA, the f32
    ``dist_topk`` spill candidates on FFMA); one fused ``probe_select`` and
    one tensor-core ``ivf_scan_select`` a served call; recall@10 within
    0.005 of an in-process build of the same rows, seed and nlist;
    every returned id's distance against float64 of ‖q − rows[id]‖²; every
    list probed, recall@10 >= 0.98; whether the daemon's lists equal the
    in-process build's is printed. It prints each fit's feed rows/s and
    GiB/s of frames, the build seconds, the served q/s after a warm-up
    beside the in-process q/s (this phase's and phases 16-17's), the
    daemon's span split and the device busy share.
23. The estimators around the kernels, on the card. StandardScaler().fit
    of 1,048,576 x 2048 float32 rows of unit scale (a rank-32 factor model
    plus noise) against float64 column moments (1e-6 relative on std), its
    transform of 65,536 rows bitwise equal to a numpy float64 recompute
    from the fitted mean and std (withMean off and on).
    ``Pipeline([StandardScaler(withMean=True), PCA(k=32)])`` on the same
    rows: one ``gram`` launch on the tensor-core route; the scaler stage
    bitwise equal to a stage-by-stage fit and the PCA stage within phase
    3's tolerance of one (the tensor-core Gram's row splits meet in no
    fixed order; whether they came out bitwise is printed); the components
    against float64 PCA of the standardized bf16 rows (phase 3's
    tolerance); save and load of the PipelineModel bitwise.
    ``CrossValidator(LinearRegression, regParam {0, 0.1, 1}, 3 folds,
    rmse)`` on 1,048,576 x 1024 bf16 rows: 10 ``linreg_stats`` launches on
    the tensor-core route, ``avgMetrics`` against a float64 ridge recompute
    over the same folds (1e-3 relative: the served product rounds the
    coefficients to bf16) and the chosen map equal to its argmin.
    ``TrainValidationSplit(binomial LogisticRegression, regParam {0, 0.01},
    areaUnderROC)`` on 524,288 x 1024 bf16 rows: the ``newton_stats``
    launches (all tensor-core) and each AUC equal to a float64 numpy AUC
    of the same scores (1e-12). Then SparkStandardScaler's feed protocol:
    phase 20's 8 forked tasks and frames (one attempt dying after a feed)
    with ``spark/estimator._drive_scaler`` as the driver; acked, ``status``
    and finalize rows 1,048,576; ``gram_colsum`` once per folded feed (17),
    all tensor-core; mean and variance against float64 of the same rows
    (1e-6 of E|x|, 2e-6 of E[x²]); ``ensure_model`` with the serving params
    and the served transform of 65,536 rows bitwise equal to
    ``transform_matrix``, the withMean=True copy under a second registry
    name. It prints each fit's seconds, the Spark scaler's rows/s and GiB/s
    of frames beside phase 20's, and the served scaler's p50.
24. The histogram RandomForest at the sizes users run, Spark's defaults
    (numTrees 20, maxDepth 5, maxBins 32, featureSubsetStrategy auto,
    bootstrap), data synthesized from a seed in public datasets' shapes:
    RandomForestClassifier on UCI HIGGS's (11,000,000 x 28, 2 classes) and
    RandomForestRegressor on UCI YearPredictionMSD's (515,345 x 90,
    integer years 1922-2011). It prints each fit's seconds, rows/s per
    level pass, the histogram-update and split-scoring ms per level (spans)
    and the device kernels (torch.profiler), the predict rows/s at 65,536
    held-out rows and the held-out accuracy and R². Checks: every tree's
    root class totals (and the regressor's root counts) equal to numpy
    float64 sums of the host bootstrap weights; ``transform_matrix`` of
    65,536 held-out rows against a numpy descent of the fitted tables (the
    predicted class equal off 1e-6 near-ties, regression means within
    1e-6); and at a 131,072-row prefix the card's fits against the card
    machine's CPU (both float32, the CPU fits in a thread beside the card's
    work): the classifier's tables bitwise, the regressor's features and
    thresholds equal and values within 1e-5 relative, except under a node
    where the two decisions differ by a near-tie (printed, its subtree
    skipped): the card's candidate scores within 1e-5 of the CPU's best,
    or, where one side stopped at a leaf, the best split scores within 1e-5
    of the node's own term (scores rebuilt in float64 from the node's rows;
    the float32 variance gains of year labels are differences of ~1e12
    terms).
25. The forests through the data plane: SparkRandomForestClassifier on
    HIGGS's shape and SparkRandomForestRegressor on YearPredictionMSD's
    (phase 24's sizes and Spark's defaults), the port's daemon in this
    process on the card, 8 task processes forked once and reused by every
    pass, each rebuilding its float32 frames (float64 labels) of phase
    24's model in numpy from the seed (RF_SEED, kind, partition, frame) and
    running ``_feed_partition`` with a ``feed_raw`` sender: 65,536-row
    frames, 21 a HIGGS partition; partition 3's attempt 0 dies after one
    feed in each fit's first scan. This process runs
    ``spark/estimator._drive_forest`` (the bin edges from the first 65,536
    rows partition-major, a creating ``set_iterate``, a scan and a ``step``
    a depth). Checks: acked, ``status``, every step's ``pass_rows`` and
    finalize rows equal the dataset's; the steps answer depths 1, 2, ...
    until no node is open, within maxDepth passes; no hand-written kernel
    launched; every tree's root statistics equal the task processes'
    float64 sums of their rows' bag weights at ``row_identity_keys
    (partition, offset)`` (the port's ``bootstrap_weights`` on the CPU);
    at a 131,072-row prefix (16,384 rows a partition) the card's daemon
    fit against a ``DataPlaneDaemon(device="cpu")`` fit in a thread beside
    it (float32 both: the classifier's tables bitwise, the regressor's
    under phase 24's near-tie rule); 1,048,576 HIGGS-shape rows fed as
    partition-less frames, bitwise equal to the in-process
    ``RandomForestClassifier.fit`` of the same rows on the card; the
    served ``rf_classifier`` and ``rf_regressor`` of 65,536 held-out rows
    through ``ensure_model`` bitwise equal to ``transform_matrix``. It
    prints each fit's rows/s and GiB/s of frames beside phase 20's, ms per
    pass and per step, the daemon's span split, the device busy share of
    one traced scan, the fit's seconds, the held-out accuracy and R², the
    served p50 and the phase's seconds.
26. The fits across processes (``parallel/``: one rank a process and a
    device, the data axis the world of ``torch.distributed`` ranks). The
    ranks are spawned processes; each checks itself, reports its numbers
    to this process over a queue and exits non-zero on a failed check;
    this process fails when a rank fails or passes its time limit, and
    kills it. a. An NCCL world of one on cuda:0: ``reduce_sum``,
    ``all_concat`` and ``reduce_topk`` of CUDA tensors against their
    inputs, nothing staged; phase 3's shapes on small-integer rows, the
    stream's state through NCCL's all_reduce bitwise equal to the fold
    without a world; ``fit_pca_stream`` of phase 3's eight batches through
    ``mesh=global_mesh()`` against phase 3's float64 reference (phase 3's
    tolerances). Then the record of what gloo does with a CUDA tensor's
    send/recv, in a pair of its own. b. Two gloo ranks, both on cuda:0
    (NCCL refuses two ranks on one device), each making only its own rows
    on the card from the phases' seeds: ``ring_shift`` of a CUDA tensor
    (staged through the host); the PCA stream at full width (d = 2048, k
    = 32, phase 3's eight bf16 batches split 5 / 3, so rank 1 yields two
    empty lockstep batches): ``gram_colsum`` launches equal each rank's
    batches, all wgmma; on small-integer rows the reduced state bitwise
    equal to one process's fold of all eight; on phase 3's rows the
    components against phase 3's float64 reference; the in-memory
    ``fit_pca`` of phase 4's 1,048,576 rows (524,288 a rank: one ``gram``
    wgmma launch a rank, phase 4's check); LinearRegression at d = 1024
    (phase 9's stream split 5 / 3 through ``streaming_normal_eq_update``
    with the mesh, and its in-memory float32 rows split in two through
    ``fit_linear_regression``; ``linreg_stats`` launches per rank, against
    float64 normal equations at phase 9's tolerance); the multinomial
    stream on phase 12's rows (80,000 / 49,838, in 3 / 2 batches, five
    passes at tol 0: ``softmax_curvature`` launches = passes x non-empty
    batches, all wgmma; (W, b) against one process's stream of the same
    batches at phase 12's tolerance); exact ``NearestNeighbors`` on phase
    16's rows (524,288 a rank, 4,096 queries, k = 10: one ``dist_topk``
    wgmma launch a rank a call; the global ids equal phase 16's
    one-process answer wherever the gap to the next distance exceeds phase
    15's tolerance); the binomial and KMeans streams (no kernel) at 65,536
    rows against one process's streams; every result bitwise identical on
    both ranks; the staged collectives. It prints per rank the fold
    kernel's ms a batch, the d = 2048 reduce's ms and bytes a batch, the
    'collective reduce' and 'lockstep gather' spans of the stream, the
    two-rank stream's rows/s beside phase 3's, and the phase's seconds.
27. The fits across daemons: phases 20-22's 8 forked task processes and
    65,536-row ``feed_raw`` frames, partitions 4-7 routed to a second
    daemon (an executor on another host feeds its own), this process the
    driver with the estimators' own functions over ``spark/estimator.
    _DaemonFit`` (the peer plane: a peer found in the acks, or seeded from
    the configured addresses through ``daemon_session.resolve_all``, its
    pass partials folded into the primary by ``reduce_mesh`` or by the
    hub's ``export_state`` + ``merge_state``, the primary's iterate pushed
    to it at each boundary). a. Two port daemons in this process on the
    card: PCA d = 2048, k = 32 (its frames cut to 32,768 rows, 524,288 a
    fit, here and in phase 28) on rows from {-1, 0, 1} (every statistic an
    exact float32 sum) through one daemon, the collective path and the hub
    (``mesh_collectives`` off), all three bitwise equal, then on phase
    20's gaussian rows against float64 (phase 20's tolerances);
    LinearRegression d = 1024 on {-1, 0, 1} rows, bitwise one daemon's;
    multinomial LogisticRegression C = 32 (131,072 rows, five passes) and
    KMeans d = 256, k = 100 (both daemons seeded) against the one-daemon
    fits at phase 21's tolerances in the same passes; the forest classifier
    on 1,048,576 HIGGS-shape rows (Spark's defaults) with tables bitwise
    one daemon's; exact and IVF knn (d = 768, nlist 1,024, nprobe 20) as
    two shards served through the fan-out: exact ids equal one daemon's
    wherever the gap exceeds phase 16's tolerance, IVF sharing one
    quantizer with recall@10 within 0.02 of one daemon's and at least 0.98
    with every list probed (the one-daemon answers are phase 22's, of the
    same rows and queries, when it ran in the same call). Every fit's
    rows, peers and reduce path are checked, and each kernel of the path
    must launch. b. Two daemon processes on the one card (two executor
    hosts): the PCA fit of a on {-1, 0, 1} rows through the hub across
    processes, bitwise one daemon's. It prints the rows/s of each fit beside phases 20 and 21's,
    the ms and bytes of a pass's reduce on each path, the knn builds'
    seconds and served q/s beside phase 22's, and its launches.
28. The elastic fits across daemons (``_DaemonFit``'s death and grow
    policies, the port's ``utils/faults.py``): phase 27's task processes
    and frames, this process the driver, the death timeout 2 s. a. Three
    port daemons in this process: PCA d = 2048, k = 32 on phase 27's
    {-1, 0, 1} rows, partitions 4-5 feeding a doomed peer (their next
    attempt failing over to the primary), 6-7 a survivor; the doomed peer
    stops at its first ``daemon.vanish`` (the collective reduce) and the
    scan replays on the survivors, bitwise phase 27's one-daemon fit (run
    here when phase 27 did not), one loss counted. d. The same PCA with
    the doomed peer a daemon process (phase 27b's) killed by SIGKILL after
    the first scan, through the hub, bitwise. e. The same PCA fed by task
    processes with ``SRML_TORCH_FAULT_PLAN`` (client op drops 5 %,
    partial frames 2 %, daemon op latency 2 ms at 25 %, the plan active in
    this process too), bitwise the fault-free fit, the tasks' reconnects
    and replays both above 0. b. KMeans d = 256, k = 100 on 524,288
    integer blob rows (maxIter 3), the peer dying at the pass-1 boundary
    sync: centres and numIter bitwise a fit on the surviving topology, the
    cost within 1e-6. c. The same KMeans growing: a third daemon added to
    the configured addresses at a pass-0 boundary failure, admitted with
    the ``boundary`` policy, equal to b's oracle, one join, the rebalanced
    rows those of partitions 4-5. Each part prints its seconds, its
    oracle's, the seconds from the death to the replay's scan and the
    elastic counters; every ``gram_colsum`` launch must take the wgmma
    route.
29. The serving plane (``serve/scheduler.py``; the ``warmup``, ``health``
    and ``metrics`` ops): two port daemons in this process on the card,
    one batching on the default ladder (64, 256, 1,024, 4,096) and the
    reference with batching off. The exact index is phase 22's 1,048,576 x
    768 float32 rows, fed once by 8 spawned client processes through
    ``feed_raw`` and ``finalize_knn`` (k = 10) and registered in the second
    daemon by ``_ServedModel.from_model``; a PCA model (d = 2048, k = 32,
    fit on 65,536 rows of phase 3's spectrum) and an IVF index (65,536 x
    768, nlist 64, nprobe 8) are in both. ``warmup`` of each model acks
    enabled, the ladder, compiled 4 and aot false, and no later traffic
    raises ``srml_scheduler_compile_misses_total``. Exact kNN over the wire:
    the 8 client processes send 32 ``kneighbors_raw`` requests each (query
    counts from {1, 16, 63, 64, 65, 256}, seeded) to the batching daemon,
    then the same to the other: every answer bitwise equal, fewer batches
    than requests, and the ``dist_topk`` launches equal to
    ``srml_scheduler_batches_total{op="kneighbors"}``, all wgmma. The
    ``health`` scheduler block, the Prometheus lines and the requests
    counted against the requests sent. IVF requests bypass the scheduler
    (``srml_scheduler_bypass_total``) with answers bitwise the other
    daemon's; a daemon with ``serve_queue_depth`` 2 answers ``busy`` and
    every client heals to the exact answers. 16 threads x 64 PCA
    transforms of {1, 8, 63, 64, 65, 200, 1,000} rows through
    ``RequestScheduler.submit``, each bitwise the other daemon's solo
    transform or within 2·γ₂₀₄₈·Σ|x||pc|, and 9 rows batched with 40 in the
    64-row bucket bitwise the 9 rows alone. It prints, batching on and
    off, requests/s, rows/s, p50 and p99 latency per request, the mean rows
    a batch and the padded share, and the device busy share; then one
    request of phase 22's 4,096 queries alone, over the wire to each daemon
    and in process through ``submit`` and ``_ServedModel.kneighbors``: the
    median of 5 and the daemon's spans a call.
30. The observability plane (``utils/{journal,xprof,slo,flight}.py``, the
    ``trace_pull`` and ``telemetry_pull`` ops). a. Phase 20's feed protocol
    (8 spawned tasks x 2 ``feed_raw`` frames of 65,536 x 2048 f32, one
    attempt dying) inside the driver's ``journal.run``, the tasks' clients
    stamping its ``trace_ctx``, with ``device_timing`` on: every
    ``daemon.feed_raw`` span the daemon's ``trace_pull`` returns is in the
    driver's run under its fit span; the kernel ledger's ``gram_colsum``
    calls equal the launches (17, all wgmma) at 65,536·2048·2049 +
    65,536·2048 flops a call; its CUDA-event seconds a call and TFLOP/s.
    b. 8 of phase 29's client processes x 16 exact ``kneighbors_raw``
    requests over a 1,048,576 x 768 bf16 index (k = 10) through a batching
    daemon's scheduler, the ring armed: the ledger's ``dist_topk`` calls
    equal the launches and the batches, and every kneighbors exemplar of
    ``srml_daemon_request_seconds`` in ``telemetry_pull`` names a span
    ``trace_pull`` returns. c. An unreachable p99 objective on kneighbors:
    ``srml_slo_breach`` reaches 1 within two telemetry ticks and the
    telemetry thread writes an ``slo_breach`` bundle under the recorder's
    (temporary) ``state_dir`` that ``load_bundle`` reads back with both
    kernels' ledger records. d. The same requests with the journal off,
    the ring armed and a journal file (requests/s each, answers bitwise
    equal); the ledger's host cost a ``dist_topk`` call and the journal's a
    span.
31. Durable daemons and the routed fleet (``serve/{daemon,gossip,router}.py``),
    every daemon a spawned process on the card. a. Phase 21's KMeans feed
    protocol (d = 256, k = 100, 8 task processes x 1 frame of 32,768 rows:
    262,144, a depth cut; phase 28's integer blobs, so every sum is exact)
    against a daemon with a ``state_dir``: a clean fit, then one under
    ``SRML_TORCH_FAULT_PLAN`` whose daemon SIGKILLs itself at
    ``daemon.pass_boundary`` when the step closing pass 1 has applied (its
    snapshot written, its ack unsent); restarted on the same port and
    ``state_dir``, the daemon keeps its instance id under a new boot id,
    restores the job (``srml_daemon_job_restores_total`` 1) and the
    driver's recovery finishes the fit, its centres bitwise the clean
    fit's; the snapshot's bytes and ms at each boundary, the seconds from
    the death to the replay's scan. b. Phase 22's knn job cut to one
    32,768-row frame a partition (262,144 x 768 rows from the 8 task
    processes; IVF nlist 1,024, nprobe 20, then exact) built by a durable
    daemon process: the snapshots' seconds and
    bytes at finalize; 4,096 queries (k = 10) before a SIGKILL and after
    the restart, whose first ``kneighbors`` of each index restores it
    lazily: answers bitwise equal; the restore seconds and the launches of
    ``lloyd_step``, ``assign_min_dist``, ``dist_topk``, ``probe_select``
    and ``ivf_scan_select`` in each incarnation. c. Three daemon processes
    (``gossip_interval_s`` 0.2, batching off, so every request is one solo
    dispatch) each holding PCA v1 and v2 (d = 2048, k = 32) and an exact
    index of 262,144 x 768 float32 rows (one 0.75 GiB ``ensure_model``
    frame, under ``MAX_FRAME``) registered by hand as a fleet control
    plane does; a ``RoutingTable`` through ``install``/``activate``, the
    ``FleetView`` pushed to one daemon, a ``FleetClient`` bootstrapped
    from one seed; a version the replica does not hold is refused, the
    held one echoed; 8 threads x 64 requests (64-row PCA transforms and
    16-query exact ``kneighbors``, k = 10; sticky and free route keys;
    four threads on the hand-built table, four bootstrapped) with one
    replica SIGKILLed mid-traffic, then 8 x 8 more once it is back:
    every request answered bitwise as one daemon answers it, the
    restarted replica repaired in band, the views of all three daemons
    converged; requests/s, p50 and p99, the failovers, the convergence
    seconds. The replicas stay up for phase 32.
32. The fleet control plane (``serve/{fleet,autoscaler}.py``, ``tools/
    {top,trace}.py``) over phase 31c's three replica processes and a spare
    one started while 31c runs. a. ``ModelFleet.from_seeds`` on one
    replica rolls PCA v2 -> v3 (d = 2048, k = 32) and the exact index v1 ->
    v2 (262,144 x 768 float32 rows plus a seeded perturbation, so the
    versions answer differently) through register, warm, flip and drain
    while 8 routing threads send phase 31c's transforms and exact queries:
    the seconds of each rollout phase, requests/s and p99 during the
    rollouts, the old versions gone from every replica (``model_status``).
    c. An ``AutoScaler`` (min 3, max 4 replicas, watermarks 1.0 / 0.3
    routed requests in flight a replica, cooldown 1 s, tick 0.2 s) on that
    fleet, its ``spawn`` hook the spare: 16 routing threads lift the load
    over the high watermark (one ``scale_up``; the newcomer's ``warmup``
    count moved and its routed count did not before its admission), then
    one thread stays (one ``scale_down``; the ``drain`` hook stops the
    victim only after the drain barrier held), inside ``journal.run`` with
    a file from which ``tools.trace`` reads both action spans;
    ``tools.top --once --fleet`` shows the three replicas up and the
    active versions. b. Two controller processes under
    ``SRML_TORCH_FAULT_PLAN``, each bootstrapped from one seed: the first
    dies (exit 17) at ``fleet.rollout`` in the ``flipped`` phase of PCA v4
    -> v5 and a successor's ``resume_rollout`` completes it; the second
    dies at ``registering`` (v5 -> v6) and its successor aborts it, v5
    serving on; the seconds from each death to the finished resume. Over
    a, b and c, every routed answer equals, bitwise, a version's solo
    answer, no thread goes back a version and none fails; the
    ``dist_topk`` launches of the phase over every replica process.
33. The model axis (``parallel/mesh.py``'s (data, model) mesh of ranks,
    ``ops/gram.sharded_stats_ring``,
    ``ops/eigh.pca_from_gram_model_sharded``, ``fit_pca``'s 2-D route,
    ``shard_index``) in four spawned gloo ranks sharing the card. a. A
    world-of-one ``fit_pca`` at d = 10,240 (a 400 MiB f32 Gram, over the
    256 MiB budget) raises ``GramCapacityError`` naming
    ``mesh_model_axis``; on a 2 x 2 mesh, 131,072 bf16 rows a data row
    made on the card from the row's seed: on {-1, 0, 1} rows the ring's
    slabs are bitwise equal to those of a plain all-gather of the full
    width (the JAX package's other form, which the port does not have) and
    to the rows of the one-process ``gram`` kernel of all 262,144 rows, and
    the ring's peak memory (``torch.cuda.max_memory_allocated``) is below
    the all-gather's; on phase 3's spectrum at that width ``fit_pca``'s
    randomized model-sharded fit (k = 32, the ring) against a float64 eigh
    of the same bf16 rows on the card (phase 3's tolerance); the seconds
    of the stats, the eigensolve and each collective. The exact solver's
    must-shard finalize (a float64 d x d assembled on the host) is not
    driven here. b. Phase 17's index (written to disk by phase 17 in the
    whole run, built here with ``--model-axis``), each rank of a 4 x 1 mesh
    memory-mapping it and keeping its 256 lists (``shard_index``); its
    4,096 queries: one
    ``probe_select`` (fused) and one ``ivf_scan_select`` (tensor cores)
    launch a rank, the answer the same on every rank and, after sorting
    each row, the unsharded query's ids with distances within rtol 1e-5
    (where rows differ the sharded recall@10 against float64 ground truth
    must not be the lower); q/s of both.
34. The port's srml-check and the daemon's start-up load
    (``tools/analyze.py``, ``serve/daemon.py``; ``--analyze`` runs it alone
    after the build, about 15 s). a. ``python -m
    spark_rapids_ml_tpu_torch.tools.analyze --json`` on this host's Python:
    zero unsuppressed findings; its seconds. b. A port daemon on the card
    started after the three kernel library loaders' caches (and
    ``_build.load``'s) were cleared: when ``start()`` returns, before any
    client has connected, all three are filled, every ``_build.load`` and
    ``_build.build`` call of the start ran outside ``_DEVICE_LOCK``; the
    seconds of its ``daemon kernel load`` span (a warm load: phase 1
    built the libraries). c. One ``gram_colsum`` fold of 4,096 x 2048
    small-integer rows through a client's ``feed_raw`` (one launch) and the
    finalize's mean equal to the rows' float64 mean within 1e-6: no
    ``_build.build`` or ``_build.load`` call while ``_DEVICE_LOCK`` is held.

The last lines are the card line, the ``{"kernels": [...]}`` table (each
row with its ``design``, from DESIGNS; the ``gram`` row times the bf16 main
path and carries the float32 route's numbers under ``f32_*``, the
``gram_colsum`` row phase 19's launches under ``daemon_launches``, the
``linreg_stats`` and ``softmax_curvature`` rows phase 21's there, the
``lloyd_step``, ``assign_min_dist``, ``dist_topk``, ``probe_select`` and
``ivf_scan_select`` rows phase 22's (summed over its parts), the ``gram``,
``linreg_stats`` and ``newton_stats`` rows phase 23's under
``estimator_launches`` and the ``gram_colsum`` row phase 23's Spark
scaler's under ``spark_scaler_launches``, the
``dist_topk`` row the FFMA tiles' time under ``ffma_ms``, the
``probe_select`` row the sort route's under ``sort_ms``, and the five rows
of phase 26's path (``gram``, ``gram_colsum``, ``linreg_stats``,
``softmax_curvature``, ``dist_topk``) its launches summed over the two
ranks under ``multiprocess_launches``, and the eight rows of phase 27's
path its two-daemon fits' and served calls' launches under
``multidaemon_launches``, the ``gram_colsum`` row phase 28's elastic
fits' launches in this process under ``elastic_launches``, the
``dist_topk``, ``probe_select`` and ``ivf_scan_select`` rows phase 29's
batched exact and bypassed IVF traffic's under ``serving_launches``, the
``gram_colsum`` and ``dist_topk`` rows phase 30's under
``telemetry_launches``, the ``lloyd_step``, ``assign_min_dist``,
``dist_topk``, ``probe_select`` and ``ivf_scan_select`` rows phase 31b's
(both incarnations of its daemon process) under ``durable_launches`` and
the ``dist_topk`` row phase 31c's (summed over its replica processes)
under ``fleet_launches`` and phase 32's under ``control_launches``, and
the ``probe_select`` and ``ivf_scan_select`` rows phase 33b's summed over
its four ranks under ``model_axis_launches``) and
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside this file, the script fails before printing any result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

D, K = 2048, 32  # bench.py:113-114
BATCH_ROWS = 1 << 18  # bench.py:115
N_BATCHES = 8  # cut from the 384 batches (100.7M rows) of bench.py:119
LAST_BATCH_ROWS = BATCH_ROWS - 12345  # the stream's ragged tail
IN_MEMORY_ROWS = 4 * BATCH_ROWS
TRANSFORM_ROWS = 65536
DEV = "cuda"

# H100 SXM data sheet peaks (dense): bf16 tensor cores, f32 FFMA, HBM3.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12

KM_D, KM_K = 256, 100  # BASELINE.json config #3 (KMeans k=100 on 50M x 256)
KM_ROWS = (1 << 24) - 12345  # depth cut from 50M rows for the smoke's time
KM_MAX_ITER, KM_TOL = 20, 1e-4  # Spark's KMeans defaults
KM_STREAM_BATCHES = 8
KM_SCALE = 0.03  # blob centres: KM_SCALE · N(0, 1) per coordinate
KM_NOISE = KM_SCALE / 1000 ** 0.5  # blob noise: 1e3 times closer than the blobs
LR_D = 1024  # linear_regression.py:85 (the 1M x 1024 shape)
LR_BATCHES = 8
LR_LAST_BATCH_ROWS = BATCH_ROWS - 12345
LR_IN_MEMORY_ROWS = 1 << 20
LG_D = 1024  # bench_logreg.py:21 (d); the binomial rows, 2^19, :22
LG_ROWS = (1 << 19) - 12345  # made ragged
LG_REG = 1e-4  # bench_logreg.py's regParam
MN_CLASSES = 32  # bench_logreg.py:83 (C); its rows, 2^17, :84
MN_ROWS = (1 << 17) - 1234  # made ragged
MN_PASSES = 5
LG_TRANSFORM_ROWS = 65536

KNN_D = 768  # bench_knn.py:29-42 (BASELINE.json config #5's width)
KNN_ROWS = 1 << 20  # depth cut from config #5's 10M rows
KNN_CLUSTERS, KNN_SPREAD = 4096, 0.35
KNN_QUERIES, KNN_K = 4096, 10
KNN_NLIST, KNN_NPROBE = 1024, 20
INPROC_QPS: dict = {}  # phases 16-17's q/s, printed beside phase 22's served q/s
#: One-daemon numbers of phases 20-22, printed beside phase 27's two-daemon
#: ones: "<phase> <run>" → rows/s, and phase 22's builds and served q/s.
ONE_DAEMON_RATES: dict = {}
P22_SERVED: dict = {}
#: Phase 27's one-daemon PCA of its {-1, 0, 1} rows ("model", "s"): phase
#: 28's PCA oracle when phase 27 ran in this call.
P27_ORACLE: dict = {}
#: Phase 17's IVF index written to disk, with its queries, float64 ground
#: truth and answer (``p17_save``): phase 33b's when phase 17 ran in this call.
P17_INDEX: dict = {}

DP_ROWS = 65536  # spark/conf.py:22,40: arrow.maxRecordsPerBatch, one feed
DP_PARTITIONS, DP_FEEDS = 8, 2  # 1,048,576 rows (BASELINE.json #1's 100M cut in depth)
DP_JOB = "phase19"
SPARK_SEED, SPARK_JOB = 20, "phase20"
SPARK_DYING = 3  # the partition whose attempt 0 dies after one feed

P23_SEED = 23
SC_ROWS = IN_MEMORY_ROWS  # phase 4's 1,048,576 x 2048
CV_ROWS, CV_D = 1 << 20, LR_D  # phase 9's width
CV_REGS, CV_FOLDS = (0.0, 0.1, 1.0), 3
TVS_ROWS, TVS_D = 1 << 19, LG_D  # phase 11's width
TVS_REGS, TVS_RATIO = (0.0, 0.01), 0.75
#: Phase 23's Spark scaler: phase 20's frames (the P21_RUNS fields).
P23_RUNS = {"scaler": ("pca", D, DP_ROWS, DP_FEEDS, K)}

RF_SEED = 24
HIGGS_ROWS, HIGGS_D = 11_000_000, 28  # UCI HIGGS: 11M rows x 28 features, 2 classes
MSD_ROWS, MSD_D = 515_345, 90  # UCI YearPredictionMSD: 515,345 rows x 90, years 1922-2011
RF_PREFIX = 1 << 17  # the card-against-CPU checks (cut from 262,144 for the smoke's time)
RF_HELDOUT = 65536
RF_TIE = 1e-5  # a regressor node within this of its best candidate may split otherwise

#: The body each kernel row of the table times (the Gram family: "wgmma+tma syrk").
DESIGNS = {
    "lloyd_step": "wgmma+tma scoring, argmin epilogue",
    "assign_min_dist": "wgmma+tma scoring, argmin epilogue",
    "ivf_scan_select": "wgmma+tma scoring, packed-key top-k epilogue",
    "dist_topk": "wgmma+tma scoring, (distance, id) top-k epilogue, f32 recompute",
    "probe_select": "ffma tiles, fused warp-sort selection, last-block merge",
}

#: Promotion intervals (stages) of the tensor-core Gram timed in phase 6.
PROMOTE_SWEEP = (0, 1, 2, 4, 8)

KERNEL_SOURCE = "spark_rapids_ml_tpu_torch/ops/csrc/gram.cu"
KMEANS_SOURCE = "spark_rapids_ml_tpu_torch/ops/csrc/kmeans.cu"
KNN_SOURCE = "spark_rapids_ml_tpu_torch/ops/csrc/knn.cu"
REPLACES = {
    "gram_colsum": "spark_rapids_ml_tpu/ops/pallas_kernels.py:173",
    "gram": "spark_rapids_ml_tpu/ops/pallas_kernels.py:78",
    "lloyd_step": "spark_rapids_ml_tpu/ops/pallas_kernels.py:314",
    "assign_min_dist": "spark_rapids_ml_tpu/ops/pallas_kernels.py:561",
    "linreg_stats": "spark_rapids_ml_tpu/ops/pallas_kernels.py:1210",
    "newton_stats": "spark_rapids_ml_tpu/ops/pallas_kernels.py:451",
    "softmax_curvature": "spark_rapids_ml_tpu/ops/pallas_kernels.py:1135",
    "dist_topk": "spark_rapids_ml_tpu/ops/pallas_kernels.py:678",
    "ivf_scan_select": "spark_rapids_ml_tpu/ops/pallas_kernels.py:860",
    "probe_select": "spark_rapids_ml_tpu/ops/pallas_kernels.py:984",
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    print(("ok    " if ok else "FAIL  ") + msg, flush=True)
    if not ok:
        fail(msg)


def run(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def rel_err(out, ref, scale) -> float:
    """max |out − ref| over a scale bounding the entries' absolute sums."""
    return float((out.double() - ref.double()).abs().max()) / max(float(scale), 1e-30)


def time_ms(fn, reps: int) -> float:
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def sign_aligned_err(pc, ref) -> float:
    """max over columns of min(|a − b|∞, |a + b|∞): sign-invariant."""
    import torch

    pc = torch.as_tensor(pc, dtype=torch.float64, device=ref.device)
    plus = (pc - ref).abs().max(dim=0).values
    minus = (pc + ref).abs().max(dim=0).values
    return float(torch.minimum(plus, minus).max())


def reference_pca(count, colsum, gram, k):
    """Float64 eigh of the centred Gram: (top-k vectors, σ/Σσ, smallest
    gap between the top k+1 eigenvalues over the largest)."""
    import torch

    g = gram - torch.outer(colsum / count, colsum)
    w, v = torch.linalg.eigh(g)
    w, v = w.flip(0), v.flip(1)
    s = torch.sqrt(torch.clamp(w, min=0))
    gap = float((w[:k] - w[1:k + 1]).min() / w[0])
    return v[:, :k], s[:k] / s.sum(), gap


def make_rows(gen, rows, scales, mu, dtype):
    """Rows with a decaying, well-separated spectrum: z·s + μ."""
    import torch

    z = torch.randn((rows, D), generator=gen, device=DEV, dtype=torch.float32)
    return (z * scales + mu).to(dtype)


def phase_kernels(torch, kernels) -> None:
    gen = torch.Generator(device=DEV).manual_seed(1)
    # Ragged against the 16-row chunk, the 8192-row split (three splits)
    # and the 128 tile.
    n, d = 20001, 300
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((n, d), generator=gen, device=DEV).to(dtype)
        gscale = float((x.float() ** 2).sum(0).max())
        cscale = float(x.float().abs().sum(0).max())
        for n_valid in (n, 17000, 1234, 0):
            for seeded in (False, True):
                g0 = torch.randn((d, d), generator=gen, device=DEV)
                cs0 = torch.randn((d,), generator=gen, device=DEV)
                c0 = torch.tensor(37.0, device=DEV)
                st_k = (g0.clone(), cs0.clone(), c0.clone()) if seeded else None
                st_p = (g0.clone(), cs0.clone(), c0.clone()) if seeded else None
                gk, csk, ck = kernels.gram_colsum(x, n_valid, st_k)
                gp, csp, cp = kernels.gram_colsum_plain(x, n_valid, st_p)
                torch.cuda.synchronize()
                tag = f"gram_colsum {str(dtype)[6:]} n={n} d={d} n_valid={n_valid} seeded={seeded}"
                # Tolerance: f32 sums in another order over <= 20001 rows,
                # 1e-5 of the largest absolute row sum of each output.
                check(rel_err(gk, gp, max(gscale, 1.0)) <= 1e-5, tag + " gram")
                check(rel_err(csk, csp, max(cscale, 1.0)) <= 1e-5, tag + " colsum")
                check(float(ck) == float(cp), tag + f" count {float(ck)}")
        mask = (torch.rand((n,), generator=gen, device=DEV) < 0.7).float()
        gk = kernels.gram(x, mask)
        gp = kernels.gram_plain(x, mask)
        torch.cuda.synchronize()
        check(
            rel_err(gk, gp, max(gscale, 1.0)) <= 1e-5,
            f"gram {str(dtype)[6:]} n={n} d={d} random {{0,1}} mask (tol 1e-5 of max Σx²)",
        )
        gk = kernels.gram(x)
        gp = kernels.gram_plain(x)
        torch.cuda.synchronize()
        check(rel_err(gk, gp, max(gscale, 1.0)) <= 1e-5,
              f"gram {str(dtype)[6:]} n={n} d={d} no mask (tol 1e-5 of max Σx²)")


def check_equal(torch, got, want, tag) -> None:
    """Bitwise equality, with the first differing entry on failure."""
    got, want = got.reshape(want.shape), want
    diff = (got != want).nonzero()
    if diff.numel():
        at = tuple(int(v) for v in diff[0])
        fail(f"{tag}: {diff.shape[0]} of {want.numel()} entries differ, first at {at}: "
             f"{float(got[at])} vs {float(want[at])} (max err "
             f"{float((got.double() - want.double()).abs().max()):.3e})")


def routed(torch, kernels, kernel, route, call):
    """call(), which must launch ``kernel`` once, on ``route``."""
    before = dict(kernels.ROUTES)
    out = call()
    torch.cuda.synchronize()
    key = f"{kernel}/{route}"
    check(kernels.ROUTES[key] == before[key] + 1
          and sum(kernels.ROUTES.values()) == sum(before.values()) + 1,
          f"{kernel} took the {route} route")
    return out


def phase_gram_tc(torch, kernels) -> None:
    """The tensor-core route against the plain versions. Small-integer bf16
    rows and integer seeds make every product and partial sum an integer
    below 2^24, so the f32 results are bitwise whatever the order: a wrong
    wgmma transpose bit, swizzle or descriptor, a tile added to the wrong
    half of G or a row summed twice shows as a differing entry."""
    gen = torch.Generator(device=DEV).manual_seed(10)

    def ints(*shape, lo=-3, hi=4):
        return torch.randint(lo, hi, shape, generator=gen, device=DEV).float()

    default = kernels.TC_PROMOTE_STAGES
    # n ragged across the 64-row stage and (at d = 8, 1000) several splits.
    for d, n in ((8, 20001), (1000, 20001), (2048, 9001), (1000, 37)):
        x = ints(n, d).to(torch.bfloat16)
        for n_valid in sorted({0, 1, min(1234, n), n, n + 5}):
            for seeded in (False, True):
                g0, cs0 = ints(d, d, lo=-50, hi=51), ints(d, lo=-50, hi=51)
                st_k = (g0.clone(), cs0.clone(), torch.tensor(37.0, device=DEV)) if seeded else None
                st_p = (g0.clone(), cs0.clone(), torch.tensor(37.0, device=DEV)) if seeded else None
                gk, csk, ck = routed(torch, kernels, "gram_colsum", "wgmma",
                                     lambda: kernels.gram_colsum(x, n_valid, st_k))
                gp, csp, cp = kernels.gram_colsum_plain(x, n_valid, st_p)
                tag = f"gram_colsum wgmma bf16 ints n={n} d={d} n_valid={n_valid} seeded={seeded}"
                check_equal(torch, gk, gp, tag + " gram")
                check_equal(torch, csk, csp, tag + " colsum")
                check(float(ck) == float(cp), tag + f": G, colsum bitwise; count {float(ck)}")
                if seeded:
                    check(gk.data_ptr() == st_k[0].data_ptr(), tag + " folded in place")
        y = ints(n)
        for masked in (False, True):
            mask = (torch.rand((n,), generator=gen, device=DEV) < 0.7).float() if masked else None
            for seeded in (False, True):
                st = [ints(*s_, lo=-50, hi=51) for s_ in ((d, d), (d,), (d,), (), ())]
                st.append(torch.tensor(37.0, device=DEV))
                sk = [t.clone() for t in st] if seeded else None
                sp = [t.clone() for t in st] if seeded else None
                out_k = routed(torch, kernels, "linreg_stats", "wgmma",
                               lambda: kernels.linreg_stats(x, y, mask, sk))
                out_p = kernels.linreg_stats_plain(x, y, mask, sp)
                tag = f"linreg_stats wgmma bf16 ints n={n} d={d} mask={masked} seeded={seeded}"
                for name, a, b in zip(("xtx", "xty", "sx", "sy", "syy", "n"), out_k, out_p):
                    check_equal(torch, a, b, f"{tag} {name}")
                print(f"ok    {tag}: all six outputs bitwise", flush=True)
        for promote in PROMOTE_SWEEP:
            kernels.TC_PROMOTE_STAGES = promote
            try:
                gk = kernels.gram_colsum(x, n)[0]
                ok = torch.equal(gk, kernels.gram_colsum_plain(x, n)[0])
            finally:
                kernels.TC_PROMOTE_STAGES = default
            check(ok, f"gram_colsum wgmma n={n} d={d} promotion every {promote} stages: bitwise")
    # Gaussian rows: f32 sums in another order, as in the FFMA checks.
    for d in (1000, 2048):
        x = torch.randn((20001, d), generator=gen, device=DEV).to(torch.bfloat16)
        gscale = float((x.float() ** 2).sum(0).max())
        gk = routed(torch, kernels, "gram_colsum", "wgmma",
                    lambda: kernels.gram_colsum(x, 20001)[0])
        err = rel_err(gk, kernels.gram_colsum_plain(x, 20001)[0], gscale)
        # Tolerance: 1e-5 of the largest Σx², the FFMA checks' tolerance.
        check(err <= 1e-5, f"gram_colsum wgmma bf16 gaussian n=20001 d={d}: rel err {err:.1e} "
                           f"(tol 1e-5)")
    # The FFMA route: bf16 at d = 300 (a 600-byte row), and float32.
    x = torch.randn((999, 300), generator=gen, device=DEV)
    routed(torch, kernels, "gram_colsum", "ffma",
           lambda: kernels.gram_colsum(x.to(torch.bfloat16), 999))
    routed(torch, kernels, "linreg_stats", "ffma",
           lambda: kernels.linreg_stats(x.to(torch.bfloat16), x[:, 0].contiguous()))
    routed(torch, kernels, "gram_colsum", "ffma",
           lambda: kernels.gram_colsum(x[:, :256].contiguous(), 999))


def phase_scan_tc(torch, kernels) -> None:
    """The tensor-core route of ivf_scan_select (bf16, d % 8 == 0) against
    its plain version, bitwise: small-integer residuals (|v| <= 3) make
    every product and score an integer below 2^24, exact in f32 in any
    order, so a wrong descriptor, swizzle, 3-D box, chunk offset, maxlen
    mask, key, list insert or merge shows as a differing entry. maxlen in
    {1, 7, 64, 255, 256, 2049} (ragged against the 256-row chunk), C in {1,
    63, 208} (ragged against the 128-slot tile and its 64-slot halves),
    blk_k in {1, 12, the route's limit}, d in {8, 768, 1000}; list 1 holds
    three valid rows (the r2 sentinel past them: its sentinel rows are
    candidates whenever blk_k > 3) and list 0 duplicated rows (equal
    scores, ties to the lower position). First, the wrapper's copy of the
    shared-memory plan (kernels.scan_smem_bytes) must equal knn.cu's own
    (scan_layout), and the limit must cover ApproximateNearestNeighbors'
    default extraction at k = 64 (ceil(1.2 · 64) = 77)."""
    lib = kernels._knn_lib()
    limit = kernels.SCAN_TC_MAX_BLK_K
    plans = 0
    for blk_k in range(1, limit + 2):
        for stages in range(1, kernels.SCAN_MAX_STAGES + 1):
            want = lib.srml_ivf_scan_tc_smem(blk_k, stages)
            got = kernels.scan_smem_bytes(blk_k, stages)
            if got != want:
                fail(f"scan_smem_bytes({blk_k}, {stages}) = {got}, knn.cu's scan_layout = {want}")
            plans += 1
    check(kernels.scan_stages(limit) >= 2 > kernels.scan_stages(limit + 1) and limit >= 77,
          f"scan_smem_bytes equals knn.cu's scan_layout at {plans} plans; blk_k limit {limit} "
          f"(stages at blk_k 12: {kernels.scan_stages(12)}, at the limit: "
          f"{kernels.scan_stages(limit)})")
    gen = torch.Generator(device=DEV).manual_seed(13)

    def ints(*shape):
        return torch.randint(-3, 4, shape, generator=gen, device=DEV).float()

    nlist = 3
    for d in (8, 768, 1000):
        for maxlen in (1, 7, 64, 255, 256, 2049):
            rows = ints(nlist, maxlen, d)
            if maxlen > 5:
                rows[0, 5] = rows[0, 2]
            r2 = 0.5 * (rows * rows).sum(2)
            r2[1, 3:] = 1e30
            rows = rows.to(torch.bfloat16)
            for c in (1, 63, 208):
                qv = ints(nlist, c, d).to(torch.bfloat16)
                for blk_k in sorted({1, 12, limit}):
                    if blk_k > maxlen:
                        continue
                    dk, pk = routed(torch, kernels, "ivf_scan_select", "wgmma",
                                    lambda: kernels.ivf_scan_select(qv, rows, r2, blk_k))
                    dp, pp = kernels.ivf_scan_select_plain(qv, rows, r2, blk_k)
                    tag = f"ivf_scan_select wgmma bf16 ints d={d} maxlen={maxlen} C={c} blk_k={blk_k}"
                    check_equal(torch, pk, pp, tag + " positions")
                    check_equal(torch, dk, dp, tag + " values")
            print(f"ok    ivf_scan_select wgmma d={d} maxlen={maxlen}: positions and values "
                  f"bitwise at C in {{1, 63, 208}}, blk_k in {{1, 12, {limit}}}", flush=True)
    # The FFMA route: float32, a width TMA cannot take, blk_k past the limit.
    rows = ints(nlist, 300, 16)
    r2 = 0.5 * (rows * rows).sum(2)
    for tag, qv, rw, blk_k in (("f32", ints(nlist, 70, 16), rows, 12),
                               ("bf16 d=12", ints(nlist, 70, 12).to(torch.bfloat16),
                                rows[..., :12].contiguous().to(torch.bfloat16), 12),
                               (f"bf16 blk_k={limit + 1}", ints(nlist, 70, 16).to(torch.bfloat16),
                                rows.to(torch.bfloat16), limit + 1)):
        r2t = r2 if rw.shape[2] == 16 else 0.5 * (rw.float() ** 2).sum(2)
        dk, pk = routed(torch, kernels, "ivf_scan_select", "ffma",
                        lambda: kernels.ivf_scan_select(qv, rw, r2t, blk_k))
        dp, pp = kernels.ivf_scan_select_plain(qv, rw, r2t, blk_k)
        check_equal(torch, pk, pp, f"ivf_scan_select ffma {tag} positions")
        check_equal(torch, dk, dp, f"ivf_scan_select ffma {tag} values")
    print("ok    ivf_scan_select FFMA route: f32, d=12 and blk_k past the limit, bitwise", flush=True)


def phase_topk_tc(torch, kernels) -> None:
    """dist_topk on both routes against its plain version, bitwise:
    small-integer rows and queries (|v| <= 3) make every product, norm and
    distance an integer below 2^24, exact in f32 in any order, so a wrong
    descriptor, swizzle, chunk offset, db tail, key, list insert, split
    merge or recompute shows as a differing entry. nq in {1, 63, 128, 129,
    4,101} (ragged against the 128-query tile and its 64-query halves), m in
    {k, 255, 256, 257, 70,001} (ragged against the 256-row chunk and the
    splits), d in {8, 64, 768, 1,000}, k in {1, 10, the route's limit, 64}
    (64 takes the FFMA tiles); about a tenth of the rows masked, a case with
    three valid rows (the (+inf, −1) tail), duplicated rows and queries on
    them under permuted ids that include negatives (ties go to the lowest
    id, not the lowest position). First, the wrapper's copy of the
    shared-memory plan (kernels.topk_smem_bytes) must equal knn.cu's own
    (topk_layout)."""
    lib = kernels._knn_lib()
    limit = kernels.TOPK_TC_MAX_K
    plans = 0
    for k in range(1, 66):
        for stages in range(1, kernels.TOPK_MAX_STAGES + 1):
            want = lib.srml_dist_topk_tc_smem(k, stages)
            got = kernels.topk_smem_bytes(k, stages)
            if got != want:
                fail(f"topk_smem_bytes({k}, {stages}) = {got}, knn.cu's topk_layout = {want}")
            plans += 1
    check(kernels.topk_stages(limit) >= 2 > kernels.topk_stages(limit + 1) and limit >= 10,
          f"topk_smem_bytes equals knn.cu's topk_layout at {plans} plans; k limit {limit} "
          f"(stages at k 10: {kernels.topk_stages(10)}, at the limit: "
          f"{kernels.topk_stages(limit)})")
    gen = torch.Generator(device=DEV).manual_seed(14)

    def ints(*shape):
        return torch.randint(-3, 4, shape, generator=gen, device=DEV).float()

    seen = set()
    for d in (8, 64, 768, 1000):
        db_all = ints(70001, d)
        db_all[5] = db_all[200]  # duplicated rows: equal distances, ties to the lower id
        db_all[30] = db_all[31]
        q_all = ints(4101, d)
        q_all[:4] = db_all[[5, 30, 200, 31]]
        db_all, q_all = db_all.to(torch.bfloat16), q_all.to(torch.bfloat16)
        for nq, m in ((1, 70001), (63, 257), (128, 256), (129, 255), (4101, 70001), (129, 10)):
            ids = (torch.randperm(m, generator=gen, device=DEV) - m // 2).int()
            mask = (torch.rand((m,), generator=gen, device=DEV) < 0.9).float()
            q, db = q_all[:nq], db_all[:m]
            for k in sorted({1, 10, limit, 64}):
                if k > m:
                    continue
                route = "wgmma" if k <= limit else "ffma"
                seen.add(route)
                dk, ik = routed(torch, kernels, "dist_topk", route,
                                lambda: kernels.dist_topk(q, db, ids, mask, k))
                dp, ip = kernels.dist_topk_plain(q, db, ids, mask, k)
                tag = f"dist_topk {route} bf16 ints nq={nq} m={m} d={d} k={k}"
                check_equal(torch, ik, ip, tag + " ids")
                check_equal(torch, dk, dp, tag + " distances")
        print(f"ok    dist_topk d={d}: ids and distances bitwise at (nq, m) in {{(1, 70001), "
              f"(63, 257), (128, 256), (129, 255), (4101, 70001), (129, 10)}}, k in {{1, 10, "
              f"{limit}, 64}}", flush=True)
    check(seen == {"wgmma", "ffma"}, f"phase 2 covered both dist_topk routes: {sorted(seen)}")
    # Three valid rows, k past them: the (+inf, −1) tail; r2 passed in, as
    # an index passes it.
    db, q = db_all[:4000], q_all[:300]
    ids = torch.randperm(4000, generator=gen, device=DEV).int()
    mask = torch.zeros((4000,), device=DEV)
    mask[[3, 1500, 3999]] = 1
    r2 = kernels.dist_topk_norms(db, mask)
    dk, ik = routed(torch, kernels, "dist_topk", "wgmma",
                    lambda: kernels.dist_topk(q, db, ids, mask, 10, r2))
    dp, ip = kernels.dist_topk_plain(q, db, ids, mask, 10)
    check_equal(torch, ik, ip, "dist_topk wgmma three valid rows ids")
    check_equal(torch, dk, dp, "dist_topk wgmma three valid rows distances")
    check(bool((ik[:, 3:] == -1).all()) and bool(torch.isinf(dk[:, 3:]).all()),
          "dist_topk wgmma three valid rows, k = 10: slots 3.. are (+inf, -1)")
    # The FFMA route: float32 and a width TMA cannot take.
    for tag, q, db in (("f32", ints(300, 64), ints(5001, 64)),
                       ("bf16 d=12", ints(300, 12).to(torch.bfloat16),
                        ints(5001, 12).to(torch.bfloat16))):
        ids = torch.randperm(5001, generator=gen, device=DEV).int()
        mask = (torch.rand((5001,), generator=gen, device=DEV) < 0.9).float()
        dk, ik = routed(torch, kernels, "dist_topk", "ffma",
                        lambda: kernels.dist_topk(q, db, ids, mask, 10))
        dp, ip = kernels.dist_topk_plain(q, db, ids, mask, 10)
        check_equal(torch, ik, ip, f"dist_topk ffma {tag} ids")
        check_equal(torch, dk, dp, f"dist_topk ffma {tag} distances")
    print("ok    dist_topk: three valid rows bitwise; FFMA route at f32 and d=12 bitwise", flush=True)


def phase_probe(torch, kernels) -> None:
    """probe_select on both routes against its plain version, bitwise:
    small-integer centroids and queries make every score exact, and the
    packed keys are unique, so any exact selection gives the same bits.
    nlist in {1, 37, 1,024, 4,099} (ragged against the 128-centroid tile
    and its eight list groups), nprobe in {1, 20, nlist} (nprobe = nlist
    > 96 takes the sort route; 96, the fused route's largest, fills shared
    memory), q in {1, 129, 4,096}, d = 100 (ragged
    against the 32-column staging), a duplicated centroid (ties to the lower
    index). First, the wrapper's copy of the fused body's shared memory
    (kernels.probe_smem_bytes) must equal knn.cu's (probe_fused_smem)."""
    lib = kernels._knn_lib()
    for nprobe in range(1, kernels.PROBE_TILE + 1):
        want = lib.srml_probe_fused_smem(nprobe)
        if kernels.probe_smem_bytes(nprobe) != want:
            fail(f"probe_smem_bytes({nprobe}) = {kernels.probe_smem_bytes(nprobe)}, knn.cu's "
                 f"probe_fused_smem = {want}")
    check(kernels.probe_route(1024, 20) == "fused" and kernels.probe_route(1024, 1024) == "sort",
          f"probe_smem_bytes equals knn.cu's probe_fused_smem at nprobe 1..{kernels.PROBE_TILE}; "
          "nprobe 20 of 1,024 fused, every list sorted")

    gen = torch.Generator(device=DEV).manual_seed(15)

    def ints(*shape):
        return torch.randint(-3, 4, shape, generator=gen, device=DEV).float()

    seen = set()
    qs_all = ints(4096, 100)
    for nlist in (1, 37, 1024, 4099):
        cent = ints(nlist, 100)
        cent[7 % nlist] = cent[0]
        for nprobe in sorted({1, min(20, nlist), min(kernels.PROBE_FUSED_MAX, nlist), nlist}):
            route = kernels.probe_route(nlist, nprobe)
            seen.add(route)
            for nq in (1, 129, 4096):
                qs = qs_all[:nq]
                pk, dk = routed(torch, kernels, "probe_select", route,
                                lambda: kernels.probe_select(cent, qs, nprobe))
                pp, dp = kernels.probe_select_plain(cent, qs, nprobe)
                tag = f"probe_select {route} ints nlist={nlist} nprobe={nprobe} q={nq}"
                check_equal(torch, pk, pp, tag + " ids")
                check_equal(torch, dk, dp, tag + " values")
        print(f"ok    probe_select nlist={nlist}: ids and values bitwise at nprobe in "
              f"{{1, 20, {kernels.PROBE_FUSED_MAX}, nlist}}, q in {{1, 129, 4096}}", flush=True)
    check(seen == {"fused", "sort"}, f"phase 2 covered both probe_select routes: {sorted(seen)}")


def phase_gram_syrk(torch, kernels) -> None:
    """gram on both SYRK bodies against its plain version: bitwise on
    small-integer rows (every product and partial sum an integer below
    2^24), at d in {8, 136, 1000, 2048} (136: a ragged second tile), with and
    without a {0, 1} mask; bf16 without a mask takes the tensor-core route,
    bf16 with a mask and f32 the FFMA route. The seeded FFMA modes
    (gram_colsum, linreg_stats with a mask) fold into non-symmetric integer
    states bitwise: each off-diagonal tile goes to both halves. Then
    gaussian rows against float64: the FFMA route's error no worse than
    1e-5 of the largest diagonal entry, printed beside the plain version's.
    Widths whose rows are not 16-byte multiples (f32 d = 13, bf16 d = 300)
    stage without cp.async and are checked the same way."""
    gen = torch.Generator(device=DEV).manual_seed(14)

    def ints(*shape, lo=-3, hi=4):
        return torch.randint(lo, hi, shape, generator=gen, device=DEV).float()

    for d, n in ((8, 20001), (136, 20001), (1000, 20001), (2048, 9001), (13, 9001), (300, 9001)):
        x = ints(n, d)
        mask = (torch.rand((n,), generator=gen, device=DEV) < 0.7).float()
        for dtype in (torch.float32, torch.bfloat16):
            xt = x.to(dtype)
            name = str(dtype)[6:]
            for m in (None, mask):
                route = "wgmma" if dtype == torch.bfloat16 and m is None and d % 8 == 0 else "ffma"
                gk = routed(torch, kernels, "gram", route, lambda: kernels.gram(xt, m))
                check_equal(torch, gk, kernels.gram_plain(xt, m),
                            f"gram {route} {name} ints n={n} d={d} mask={m is not None}")
            if dtype == torch.bfloat16 and d % 8 == 0:
                continue  # its seeded modes run on the tensor-core body (phase_gram_tc)
            g0, cs0 = ints(d, d, lo=-50, hi=51), ints(d, lo=-50, hi=51)
            st_k = (g0.clone(), cs0.clone(), torch.tensor(37.0, device=DEV))
            st_p = (g0.clone(), cs0.clone(), torch.tensor(37.0, device=DEV))
            gk, csk, ck = routed(torch, kernels, "gram_colsum", "ffma",
                                 lambda: kernels.gram_colsum(xt, n - 7, st_k))
            gp, csp, cp = kernels.gram_colsum_plain(xt, n - 7, st_p)
            check_equal(torch, gk, gp, f"gram_colsum ffma {name} ints d={d} seeded gram")
            check_equal(torch, csk, csp, f"gram_colsum ffma {name} ints d={d} seeded colsum")
            y = ints(n)
            st = [ints(*s_, lo=-50, hi=51) for s_ in ((d, d), (d,), (d,), (), ())]
            st.append(torch.tensor(37.0, device=DEV))
            sk, sp = [t.clone() for t in st], [t.clone() for t in st]
            out_k = routed(torch, kernels, "linreg_stats", "ffma",
                           lambda: kernels.linreg_stats(xt, y, mask, sk))
            out_p = kernels.linreg_stats_plain(xt, y, mask, sp)
            for nm, a, b in zip(("xtx", "xty", "sx", "sy", "syy", "n"), out_k, out_p):
                check_equal(torch, a, b, f"linreg_stats ffma {name} ints d={d} masked seeded {nm}")
            print(f"ok    gram, gram_colsum, linreg_stats FFMA SYRK {name} ints n={n} d={d}: "
                  f"bitwise, seeded non-symmetric states", flush=True)
    for d in (8, 136, 1000, 2048, 13):
        x = torch.randn((20001, d), generator=gen, device=DEV)
        w = torch.rand((20001,), generator=gen, device=DEV)  # a weight outside {0, 1}
        x64 = x.double()
        for m in (None, w):
            xm64 = x64 if m is None else x64 * m.double()[:, None]
            g64 = xm64.T @ xm64
            scale = float(g64.diagonal().max())
            ek = rel_err(kernels.gram(x, m), g64, scale)
            ep = rel_err(kernels.gram_plain(x, m), g64, scale)
            check(ek <= 1e-5, f"gram ffma f32 gaussian n=20001 d={d} weights={m is not None}: "
                              f"vs float64 {ek:.2e} (tol 1e-5), plain {ep:.2e}")


def phase_kmeans_tc(torch, kernels) -> None:
    """The tensor-core route of lloyd_step and assign_min_dist (bf16,
    d % 8 == 0) against their plain versions, bitwise: small-integer rows
    and centres (|v| <= 8) make every product, score and sum an integer
    below 2^24, exact in f32 in any order, so a wrong descriptor, swizzle,
    chunk offset, tie rule or row count shows as a differing entry. The
    shapes cover the fused pass (one and several resident chunks) and the
    two-pass step (resident and streamed centres), n ragged across the
    64-row tiles, n_valid past either end, and duplicated centres (exact
    ties for every row, which must go to the lowest index), and k = 50,000
    (streamed score constants: shared memory that does not grow with k).
    First, the wrapper's copy of the shared-memory layout
    (kernels.kmeans_smem_bytes) must equal kmeans.cu's own (tc_layout)."""
    gen = torch.Generator(device=DEV).manual_seed(12)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lib = kernels._kmeans_lib()
    layouts = 0
    for fused, resident in ((True, True), (False, True), (False, False)):
        for width in kernels.KMEANS_WIDTHS:
            for k in (1, 7, 100, 129, 1024, 50_000):
                for d in (8, 256, 768, 1000):
                    for stages in range(1, kernels.KMEANS_MAX_STAGES + 1):
                        want = lib.srml_kmeans_tc_smem(int(fused), width, k, d, int(resident),
                                                       stages)
                        got = kernels.kmeans_smem_bytes(fused, width, k, d, resident, stages)
                        if got != want:
                            fail(f"kmeans_smem_bytes{(fused, width, k, d, resident, stages)} = "
                                 f"{got}, kmeans.cu's tc_layout = {want}")
                        layouts += 1
    print(f"ok    kmeans_smem_bytes equals kmeans.cu's tc_layout at {layouts} launches", flush=True)

    def ints(*shape):
        return torch.randint(-8, 9, shape, generator=gen, device=DEV).float()

    n = 20001
    seen = set()
    shapes = [(d, k) for d in (8, 256, 768, 1000) for k in (1, 7, 100, 129, 1024)]
    x = None
    for d, k in shapes + [(256, 50_000)]:
        if x is None or x.shape[1] != d:
            x = ints(n, d).to(torch.bfloat16)
        c = ints(k, d)
        if k > 2:  # exact ties: the duplicates must never win
            c[k - 1] = c[1]
            c[k // 2] = c[1]
        c = c.to(torch.bfloat16)
        lp = kernels.kmeans_plan(k, d, "wgmma", n, sms)
        ap = kernels.kmeans_plan(k, d, "wgmma", n, sms, lloyd=False)
        kind = ("fused" if lp.fused else "two-pass", "resident" if ap.resident else "streamed")
        seen.add(kind)
        tag = f"bf16 ints n={n} d={d} k={k} ({kind[0]} Lloyd, {kind[1]} centres, width " \
              f"{lp.width})"
        ik, dk = routed(torch, kernels, "assign_min_dist", "wgmma",
                        lambda: kernels.assign_min_dist(x, c))
        ip, dp = kernels.assign_min_dist_plain(x, c)
        check_equal(torch, ik, ip, f"assign_min_dist wgmma {tag} idx")
        check_equal(torch, dk, dp, f"assign_min_dist wgmma {tag} dist")
        if k > 2:
            check(not bool(((ik == k - 1) | (ik == k // 2)).any()),
                  f"assign_min_dist wgmma {tag}: duplicated centres never win")
        for n_valid in (0, 1, 1234, n, n + 5):
            sk, ck = routed(torch, kernels, "lloyd_step", "wgmma",
                            lambda: kernels.lloyd_step(x, c, n_valid))
            sp, cp = kernels.lloyd_step_plain(x, c, n_valid)
            check_equal(torch, sk, sp, f"lloyd_step wgmma {tag} n_valid={n_valid} sums")
            check_equal(torch, ck, cp, f"lloyd_step wgmma {tag} n_valid={n_valid} counts")
        print(f"ok    {tag}: idx, dist, sums and counts bitwise at n_valid in "
              f"{{0, 1, 1234, n, n + 5}}", flush=True)
    check(len({s for s, _ in seen}) == 2 and len({r for _, r in seen}) == 2,
          f"phase 2 covered both Lloyd passes and both centre layouts: {sorted(seen)}")
    # The FFMA route: bf16 at d = 300 and d = 13 (row strides TMA cannot
    # take), and float32.
    for d, dtype in ((300, torch.bfloat16), (13, torch.bfloat16), (256, torch.float32)):
        x = ints(999, d).to(dtype)
        c = ints(37, d).to(dtype)
        ik, _ = routed(torch, kernels, "assign_min_dist", "ffma",
                       lambda: kernels.assign_min_dist(x, c))
        check_equal(torch, ik, kernels.assign_min_dist_plain(x, c)[0],
                    f"assign_min_dist ffma d={d} {str(dtype)[6:]} idx")
        sk, ck = routed(torch, kernels, "lloyd_step", "ffma",
                        lambda: kernels.lloyd_step(x, c, 999))
        sp, cp = kernels.lloyd_step_plain(x, c, 999)
        check_equal(torch, sk, sp, f"lloyd_step ffma d={d} {str(dtype)[6:]} sums")
        check_equal(torch, ck, cp, f"lloyd_step ffma d={d} {str(dtype)[6:]} counts")
    # The FFMA two-pass step (k x d sums past shared memory), f32.
    x = ints(5001, 768)
    c = ints(1024, 768)
    sk, ck = routed(torch, kernels, "lloyd_step", "ffma", lambda: kernels.lloyd_step(x, c, 5001))
    sp, cp = kernels.lloyd_step_plain(x, c, 5001)
    check_equal(torch, sk, sp, "lloyd_step ffma two-pass f32 d=768 k=1024 sums")
    check_equal(torch, ck, cp, "lloyd_step ffma two-pass f32 d=768 k=1024 counts")
    print("ok    FFMA route: d=300, d=13 and f32 report ffma; its two-pass step bitwise", flush=True)


#: Bound of the tensor-core route's Hessian/curvature against the plain
#: (f32-weighted) version, over each output's largest Σ|terms|: each term
#: is rounded twice (bf16(wt), then bf16(x·bf16(wt))), at most 2⁻⁸ of it
#: each, and the roundings of many rows are independent, so their sum stays
#: far below 2⁻⁸ of Σ|terms| (stated before the first chip run).
ROUNDING_BOUND = 2.0 ** -8


def syrk_emulation(torch, kernels, x, wt, xd=None):
    """The tensor-core route's weighted Gram of bf16 rows x, bf16(x·bf16(wt))ᵀx,
    summed in xd's dtype (xd: x in that dtype; f32 when None) over the
    upper 128-tile pairs, each lower tile the transpose of its upper one:
    G[j, i] = Σ bf16(x_j·wt)·x_i, as the SYRK epilogue writes it (the full
    product would round x_i·wt there instead)."""
    xd = x.float() if xd is None else xd
    h = (x * wt.to(torch.bfloat16)[:, None]).to(xd.dtype).T @ xd
    t = torch.arange(x.shape[1], device=h.device) // kernels.TC_TILE
    return torch.where(t[:, None] > t[None, :], h.T, h)


def newton_checks(torch, kernels, x, y, mask, w, b, tag, tol):
    """newton_stats on the tensor-core route against (a) an emulation of
    its own rounding, bf16(x·bf16(wgt)) from the row pass's own weights
    summed in f32, at ``tol`` of the largest Σ|terms|, and (b) its plain
    version: the Hessian within ROUNDING_BOUND of its Σ|terms|, the
    gradient and borders (f32 on both) at ``tol``. Returns the Hessian's
    error against the emulation over the largest Σ|terms|."""
    n, d = x.shape
    out = routed(torch, kernels, "newton_stats", "wgmma",
                 lambda: kernels.newton_stats_launch(x, y, mask, w, b))
    ref = kernels.newton_stats_plain(x, y, mask, w, b)
    xf = x.float()
    wgt = out[6]
    # The largest Σ|terms| is a diagonal entry's (Cauchy–Schwarz): Σ wgt·x².
    s_terms = float((xf * xf * wgt[:, None]).sum(0).max())
    e_emul = rel_err(out[2], syrk_emulation(torch, kernels, x, wgt), s_terms)
    e_plain = rel_err(out[2], ref[2], s_terms)
    m = torch.ones((n,), device=DEV) if mask is None else mask
    xa = (xf.abs() * m[:, None]).sum(0).max()
    scales = (float(xa), float(m.sum()), 0.25 * float(xa), 0.25 * float(m.sum()))
    errs = [rel_err(a, c, max(s, 1.0)) for a, c, s in zip(out[:2] + out[3:5], ref[:2] + ref[3:],
                                                          scales)]
    check(e_emul <= tol and e_plain <= ROUNDING_BOUND and all(e <= tol for e in errs),
          f"{tag}: Hessian vs its rounding emulated {e_emul:.1e} (tol {tol:.0e}), vs plain "
          f"{e_plain:.1e} (tol 2^-8); Xᵀr, Σr, Xᵀwgt, Σwgt vs plain "
          + ", ".join(f"{e:.1e}" for e in errs) + f" (tol {tol:.0e})")
    return e_emul


def phase_weighted_tc(torch, kernels) -> None:
    """The tensor-core route of softmax_curvature and newton_stats (bf16,
    d % 8 == 0) against their plain versions. softmax_curvature bitwise:
    small-integer rows and dyadic weights p in {0, 1/4, 1/2, 1} make
    bf16(x·bf16(p)) exact and every product and partial sum a multiple of
    1/4 below 2^22, so a wrong descriptor, swizzle, weighted panel, class
    offset or border shows as a differing entry. newton_stats (sigmoid
    weights) at tolerance, through ``newton_checks``."""
    gen = torch.Generator(device=DEV).manual_seed(11)
    quarters = torch.tensor([0.0, 0.25, 0.5, 1.0], device=DEV)
    default = kernels.TC_PROMOTE_STAGES
    # n ragged across the 64-row stage and (at d = 8) several splits.
    for d, n in ((8, 20001), (1000, 20001), (1024, 9001), (1024, 37)):
        x = torch.randint(-3, 4, (n, d), generator=gen, device=DEV).to(torch.bfloat16)
        for c in (1, 3, 32):
            for masked in (False, True):
                p = quarters[torch.randint(0, 4, (n, c), generator=gen, device=DEV)]
                if masked:  # masked rows: p = 0 in every class
                    p = p * (torch.rand((n, 1), generator=gen, device=DEV) < 0.7).float()
                hk, bk = routed(torch, kernels, "softmax_curvature", "wgmma",
                                lambda: kernels.softmax_curvature(x, p))
                hp, bp = kernels.softmax_curvature_plain(x, p)
                tag = f"softmax_curvature wgmma bf16 ints n={n} d={d} C={c} mask={masked}"
                check_equal(torch, hk, hp, tag + " Xᵀdiag(p_c)X")
                check_equal(torch, bk, bp, tag + " Xᵀp_c")
                print(f"ok    {tag}: both outputs bitwise", flush=True)
        p = quarters[torch.randint(0, 4, (n, 3), generator=gen, device=DEV)]
        want = kernels.softmax_curvature_plain(x, p)[0]
        for promote in PROMOTE_SWEEP:
            kernels.TC_PROMOTE_STAGES = promote
            try:
                ok = torch.equal(kernels.softmax_curvature(x, p)[0], want)
            finally:
                kernels.TC_PROMOTE_STAGES = default
            check(ok, f"softmax_curvature wgmma n={n} d={d} C=3 promotion every {promote} "
                      f"stages: bitwise")
    # Tolerance: f32 sums in another order over <= 20,001 rows, 1e-5 of
    # each output's largest Σ|terms| (the FFMA checks' tolerance).
    for d, n in ((8, 20001), (1000, 20001), (1024, 20001), (1024, 37)):
        x = torch.randn((n, d), generator=gen, device=DEV).to(torch.bfloat16)
        y = (torch.rand((n,), generator=gen, device=DEV) < 0.5).float()
        w = torch.randn((d,), generator=gen, device=DEV) / d ** 0.5
        b = torch.tensor(0.3, device=DEV)
        for masked in (False, True):
            mask = (torch.rand((n,), generator=gen, device=DEV) < 0.7).float() if masked else None
            newton_checks(torch, kernels, x, y, mask, w, b,
                          f"newton_stats wgmma bf16 n={n} d={d} mask={masked}", 1e-5)


def margin_data(torch, gen, n, d, k, dtype):
    """Rows at small noise around k random centres: each row's nearest
    centre wins by a wide margin, so f32 sums in any order agree on it."""
    centers = torch.randn((k, d), generator=gen, device=DEV)
    lab = torch.randint(0, k, (n,), generator=gen, device=DEV)
    x = centers[lab] + 0.05 * torch.randn((n, d), generator=gen, device=DEV)
    return x.to(dtype), centers.to(dtype)


def check_assign(torch, kernels, x, c, tag) -> None:
    """assign_min_dist vs its plain version. Per row the tolerance is 1e-5
    of the terms' magnitude, s = ‖c‖² + 2Σ|x·c| at the plain winner (f32
    sums in another order); indices may differ only where the plain top
    two scores are within that tolerance, and there the kernel's pick must
    score within it of the plain minimum."""
    ik, dk = kernels.assign_min_dist(x, c)
    ip, dp = kernels.assign_min_dist_plain(x, c)
    torch.cuda.synchronize()
    xf, cf = x.float(), c.float()
    c2 = kernels.center_norms(c, half=False)
    tol = 1e-5 * (c2[ip.long()] + 2 * (xf.abs() * cf[ip.long()].abs()).sum(1))
    check(bool(((dk - dp).abs() <= tol).all()), tag + " part_d within 1e-5 of ‖c‖² + 2Σ|x·c|")
    diff = (ik != ip).nonzero()[:, 0]
    if diff.numel():
        scores = c2[None, :] - 2.0 * (xf[diff] @ cf.T)
        picked = scores.gather(1, ik[diff].long()[:, None])[:, 0]
        near = (picked - dp[diff]).abs() <= tol[diff]
        check(bool(near.all()), tag + f" {diff.numel()} differing indices are all near-ties")
    print(f"ok    {tag} indices: {x.shape[0] - diff.numel()} equal, "
          f"{diff.numel()} near-tie rows differ", flush=True)


def center_abs_sums(torch, kernels, x, c):
    """(k, d) sums of |x| over the rows nearest each centre (plain
    assignment), in 1M-row chunks: the scale of the Lloyd sums' error."""
    out = torch.zeros(c.shape, dtype=torch.float32, device=DEV)
    for r0 in range(0, x.shape[0], 1 << 20):
        xv = x[r0:r0 + (1 << 20)]
        a, _ = kernels.assign_min_dist_plain(xv, c)
        out.index_add_(0, a.long(), xv.float().abs())
    return out


def phase_new_kernels(torch, kernels) -> None:
    """linreg_stats, lloyd_step and assign_min_dist against their plain
    versions at ragged shapes (n = 20,001 over 3 row splits and 157 row
    tiles, d = 300 over 10 staged column steps), bf16 and f32."""
    gen = torch.Generator(device=DEV).manual_seed(2)
    n, d = 20001, 300
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        x = torch.randn((n, d), generator=gen, device=DEV).to(dtype)
        y = torch.randn((n,), generator=gen, device=DEV)
        for masked in (False, True):
            mask = (torch.rand((n,), generator=gen, device=DEV) < 0.7).float() if masked else None
            xm = x.float() * (1 if mask is None else mask[:, None])
            ym = y * (1 if mask is None else mask)
            gscale = float((xm ** 2).sum(0).max())
            scales = (gscale, (gscale * float((ym ** 2).sum())) ** 0.5,
                      float(xm.abs().sum(0).max()), float(ym.abs().sum()), float((ym ** 2).sum()))
            for seeded in (False, True):
                st = [torch.randn(s, generator=gen, device=DEV) for s in ((d, d), (d,), (d,), (), ())]
                st.append(torch.tensor(37.0, device=DEV))
                sk = [t.clone() for t in st] if seeded else None
                sp = [t.clone() for t in st] if seeded else None
                out_k = kernels.linreg_stats(x, y, mask, sk)
                out_p = kernels.linreg_stats_plain(x, y, mask, sp)
                torch.cuda.synchronize()
                tag = f"linreg_stats {name} n={n} d={d} mask={masked} seeded={seeded}"
                names = ("xtx", "xty", "sx", "sy", "syy")
                # Tolerance: f32 sums in another order over <= 20,001 rows,
                # 1e-5 of each output's largest absolute sum of terms.
                errs = [rel_err(a, b, max(s, 1.0)) for a, b, s in zip(out_k, out_p, scales)]
                check(all(e <= 1e-5 for e in errs),
                      tag + " " + ", ".join(f"{m} {e:.1e}" for m, e in zip(names, errs)))
                check(float(out_k[5]) == float(out_p[5]), tag + f" count {float(out_k[5])} exact")
                if seeded:
                    check(out_k[0].data_ptr() == sk[0].data_ptr(), tag + " folded in place")
        for k in (1, 100, 1000):
            xk, ck = margin_data(torch, gen, n, d, k, dtype)
            for n_valid in (n, 17000, 0):
                sk_, nk = kernels.lloyd_step(xk, ck, n_valid)
                sp_, np_ = kernels.lloyd_step_plain(xk, ck, n_valid)
                torch.cuda.synchronize()
                tag = f"lloyd_step {name} n={n} d={d} k={k} n_valid={n_valid}"
                check(tuple(sk_.shape) == (k, d) and tuple(nk.shape) == (k,), tag + " shapes")
                check(bool((nk == np_).all()) and float(nk.sum()) == n_valid,
                      tag + f" counts equal as integers (sum {int(nk.sum())})")
                # Tolerance: 1e-5 of the largest per-centre absolute sum.
                abs_sums = center_abs_sums(torch, kernels, xk[:n_valid], ck)
                err = rel_err(sk_, sp_, max(float(abs_sums.max()), 1.0))
                check(err <= 1e-5, tag + f" sums rel err {err:.1e} (tol 1e-5)")
            check_assign(torch, kernels, xk, ck, f"assign_min_dist {name} margin data k={k}")
        # Random data and centres: near-ties happen; the rule above applies.
        c = torch.randn((1000, d), generator=gen, device=DEV).to(dtype)
        check_assign(torch, kernels, x, c, f"assign_min_dist {name} random data k=1000")
        # Duplicate centres: the lowest index wins every tie.
        xk, ck = margin_data(torch, gen, n, d, 100, dtype)
        ck[57] = ck[3]
        ck[99] = ck[3]
        ik, _ = kernels.assign_min_dist(xk, ck)
        sums, counts = kernels.lloyd_step(xk, ck, n)
        torch.cuda.synchronize()
        check(int(counts[57]) == 0 and int(counts[99]) == 0 and int(counts[3]) > 0
              and not bool(((ik == 57) | (ik == 99)).any()),
              f"{name} duplicate centres 3 = 57 = 99: all ties to index 3 "
              f"({int(counts[3])} rows)")


def bound_ms(n_bytes: float, ops: float, dtype: str):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[dtype] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def promote_sweep(torch, kernels, timed, fresh, g64, scale, tag) -> None:
    """The tensor-core body at each promotion interval: its time (seeded
    launches, as the path runs them) and its Gram error against float64."""
    default = kernels.TC_PROMOTE_STAGES
    try:
        for promote in PROMOTE_SWEEP:
            kernels.TC_PROMOTE_STAGES = promote
            ms = time_ms(timed, 5)
            err = rel_err(fresh(), g64, scale)
            print(f"{tag} promotion every {promote} stages"
                  f"{' (the default)' if promote == default else ''}: {ms:.3f} ms, "
                  f"Gram vs float64 {err:.3e}", flush=True)
    finally:
        kernels.TC_PROMOTE_STAGES = default


def span_seconds(prof, name: str) -> float:
    """Host-clock seconds of the ``trace_span`` ranges called ``name`` in a
    CPU-only ``torch.profiler`` trace (the spans end on a host read of a
    device result, so they cover the device work)."""
    return sum(e.time_range.elapsed_us() for e in prof.events() if e.name == name) / 1e6


def torch_route(torch, kernels, x, c, lloyd):
    """The KMeans kernels' function through PyTorch calls alone, the
    second yardstick: per 4M-row chunk a bf16 torch.matmul for the
    products, the scores in f32, first_argmin, then index_add_ and
    bincount for a Lloyd step (or a gather of the minimum)."""
    from spark_rapids_ml_tpu_torch.ops.distances import first_argmin

    k = c.shape[0]
    cn = kernels.center_norms(c, half=lloyd)
    sums = torch.zeros((k, x.shape[1]), device=DEV)
    counts = torch.zeros((k,), dtype=torch.int64, device=DEV)
    out = []
    for r0 in range(0, x.shape[0], 1 << 22):
        xv = x[r0:r0 + (1 << 22)]
        scores = cn[None, :] - (1.0 if lloyd else 2.0) * torch.matmul(xv, c.T).float()
        a = first_argmin(scores)
        if lloyd:
            sums.index_add_(0, a, xv.float())
            counts += torch.bincount(a, minlength=k)
        else:
            out.append(scores.gather(1, a[:, None]))
    return (sums, counts) if lloyd else out


def blob_rows(torch, gen, centers, cdf, rows, dtype):
    """Rows of the blob mixture: a centre drawn by the cumulative weights
    ``cdf``, plus gaussian noise of scale KM_NOISE; made in 1M-row chunks."""
    out = torch.empty((rows, centers.shape[1]), dtype=dtype, device=DEV)
    for r0 in range(0, rows, 1 << 20):
        m = min(rows, r0 + (1 << 20)) - r0
        lab = torch.searchsorted(cdf, torch.rand((m,), generator=gen, device=DEV))
        lab = torch.clamp(lab, max=centers.shape[0] - 1)
        noise = torch.randn((m, centers.shape[1]), generator=gen, device=DEV)
        out[r0:r0 + m] = (centers[lab] + KM_NOISE * noise).to(dtype)
    return out


def lloyd_reference(torch, x, centers, cd):
    """float64 over all rows of x at ``centers`` (numpy (k, d)) rounded to
    ``cd``, the compute dtype the fit scores with (bf16 on the card; the
    JAX package casts the centres so too, kmeans.py:205-207): the means of
    the rows nearest each centre, their counts, and the cost."""
    c = torch.as_tensor(centers, device=DEV).to(cd).double()
    k = c.shape[0]
    sums = torch.zeros_like(c)
    counts = torch.zeros((k,), dtype=torch.float64, device=DEV)
    cost = torch.zeros((), dtype=torch.float64, device=DEV)
    c2 = (c * c).sum(1)
    for r0 in range(0, x.shape[0], 1 << 20):
        xd = x[r0:r0 + (1 << 20)].double()
        d2 = torch.clamp((xd * xd).sum(1)[:, None] + c2[None, :] - 2.0 * (xd @ c.T), min=0)
        best, a = d2.min(dim=1)
        sums.index_add_(0, a, xd)
        counts += torch.bincount(a, minlength=k).double()
        cost += best.sum()
    means = sums / torch.clamp(counts, min=1)[:, None]
    return means, counts, float(cost)


def phase_kmeans(torch, kernels, km, config):
    """Phases 7 and 8; returns (x, centres, launches) for the timing."""
    gen = torch.Generator(device=DEV).manual_seed(3)
    # 100 blobs with sizes from 1 to 2 in proportion. Their squared
    # distances are 1e3 times those within a blob: wider, and the f32 cost
    # ‖c‖² − 2x·c + ‖x‖² (the JAX formula) loses more than 1e-4 to rounding
    # errors shared by a tight blob's rows. So k-means++ may seed a blob
    # twice; such a split converges geometrically in units of the noise,
    # and the small scale (tol = 1e-4 is 0.1 of the noise, the bf16
    # rounding of the centres about 0.05) lets it converge within maxIter.
    true_c = KM_SCALE * torch.randn((KM_K, KM_D), generator=gen, device=DEV)
    w = 1.0 + torch.arange(KM_K, dtype=torch.float32, device=DEV) / (KM_K - 1)
    cdf = torch.cumsum(w, 0) / w.sum()
    x = blob_rows(torch, gen, true_c, cdf, KM_ROWS, torch.bfloat16)
    print(f"kmeans: {KM_ROWS} x {KM_D} bf16 rows of {KM_K} unequal blobs (noise {KM_NOISE}) "
          f"(depth cut from BASELINE.json's 50M rows), k={KM_K}, k-means++, "
          f"maxIter {KM_MAX_ITER}, tol {KM_TOL}", flush=True)
    torch.cuda.synchronize()
    kernels.reset_launches()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        sol = km.fit_kmeans(x, KM_K, max_iter=KM_MAX_ITER, tol=KM_TOL, seed=0)
        fit_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    routes = dict(kernels.ROUTES)
    check(launches["lloyd_step"] == sol.n_iter,
          f"lloyd_step launches {launches['lloyd_step']} == n_iter {sol.n_iter}")
    check(launches["assign_min_dist"] == 1,
          f"assign_min_dist launches {launches['assign_min_dist']} == 1 (the cost)")
    check(routes["lloyd_step/wgmma"] == sol.n_iter and routes["assign_min_dist/wgmma"] == 1
          and routes["lloyd_step/ffma"] == routes["assign_min_dist/ffma"] == 0,
          f"every KMeans launch on the bf16 rows took the tensor-core route (fused "
          f"{kernels.kmeans_plan(KM_K, KM_D, 'wgmma', KM_ROWS, 132).fused}): "
          + str({k_: v for k_, v in routes.items() if k_.split('/')[0] in ('lloyd_step', 'assign_min_dist')}))
    init_s, lloyd_s = span_seconds(prof, "kmeans init"), span_seconds(prof, "lloyd")
    print(f"kmeans fit: {fit_s:.3f} s = init (host k-means++) {init_s:.3f} s + Lloyd "
          f"{lloyd_s:.3f} s for {sol.n_iter} iterations and the cost pass: "
          f"{lloyd_s / sol.n_iter * 1e3:.2f} ms per iteration, "
          f"{KM_ROWS * sol.n_iter / lloyd_s:.1f} rows/s through the loop", flush=True)
    check(sol.centers.shape == (KM_K, KM_D) and bool(torch.isfinite(
        torch.as_tensor(sol.centers)).all()) and sol.n_rows == KM_ROWS,
        f"kmeans centres finite, shape {sol.centers.shape}, n_rows {sol.n_rows}")
    check(sol.n_iter < KM_MAX_ITER, f"kmeans converged (moved² <= tol²) in {sol.n_iter} "
          f"of {KM_MAX_ITER} iterations")
    cd = config.compute_dtype(DEV)
    means, counts, cost64 = lloyd_reference(torch, x, sol.centers, cd)
    c = torch.as_tensor(sol.centers, device=DEV)
    live = counts > 0
    fp_err = float((means[live] - c[live]).abs().max())
    # Tolerance: a converged fit moved each centre by at most tol = 1e-4 in
    # its last step, and a split blob's next step is smaller; its float32
    # means carry about 1e-8. Twice tol covers both.
    check(fp_err <= 2e-4, f"kmeans fixed point: float64 means of the rows nearest each "
          f"centre vs the centres, max err {fp_err:.3e} (tol 2e-4; "
          f"{int(live.sum())} of {KM_K} centres hold rows)")
    cost_err = abs(sol.cost - cost64) / cost64
    # Tolerance: the f32 cost sums ‖c‖² − 2x·c + ‖x‖² per row, terms 1e3
    # times the distance whose rounding errors a blob's rows share in part.
    check(cost_err <= 1e-4, f"kmeans trainingCost {sol.cost:.6e} vs float64 {cost64:.6e} "
          f"at the {str(cd)[6:]} centres: rel err {cost_err:.3e} (tol 1e-4)")
    centers_c = c.to(x.dtype).contiguous()

    # -- 8. streaming fit against the in-memory fit from the same init -------
    rows = KM_STREAM_BATCHES * BATCH_ROWS
    batches = [blob_rows(torch, gen, true_c, cdf, BATCH_ROWS, torch.float32)
               for _ in range(KM_STREAM_BATCHES)]
    kernels.reset_launches()
    t0 = time.perf_counter()
    s_sol = km.fit_kmeans_stream(lambda: iter(batches), KM_K, KM_D, max_iter=KM_MAX_ITER,
                                 tol=KM_TOL, seed=5, init_sample_rows=rows)
    stream_s = time.perf_counter() - t0
    check(sum(kernels.LAUNCHES.values()) == 0, "fit_kmeans_stream launches no kernel "
          "(as in the JAX package)")
    # The same seed over the same rows gives the same k-means++ sample.
    m_sol = km.fit_kmeans(torch.cat(batches), KM_K, max_iter=KM_MAX_ITER, tol=KM_TOL, seed=5)
    del batches
    err = float(abs(s_sol.centers - m_sol.centers).max())
    print(f"kmeans stream: {KM_STREAM_BATCHES} f32 batches, {rows} rows, {s_sol.n_iter} "
          f"iterations in {stream_s:.3f} s (init included); in-memory {m_sol.n_iter}",
          flush=True)
    # Tolerance: the two paths sum the same bf16 rows in float32 in other
    # orders (index_add_ atomics vs the kernel's blocks), about 1e-9 here,
    # and may score a row on a split blob's boundary differently, each such
    # row moving a centre by about 1e-6; 5e-5 is 0.05 of the noise.
    check(s_sol.n_iter == m_sol.n_iter and err <= 5e-5,
          f"stream vs in-memory from the same init: same iterations, centres max err "
          f"{err:.3e} (tol 5e-5)")
    return x, centers_c, launches


def lr_batch(torch, gen, rows, w, dtype):
    x = torch.randn((rows, LR_D), generator=gen, device=DEV).to(dtype)
    y = x.float() @ w + 0.5 + 0.1 * torch.randn((rows,), generator=gen, device=DEV)
    return x, y


def lr_reference(torch, parts, lr, reg=0.0, alpha=0.0):
    """Float64 statistics of (x, y) parts on the card and the port's
    finalize of them in float64: the solve the fit is held to."""
    stats = lr.init_normal_eq_stats(LR_D, torch.float64, DEV)
    for x, y in parts:
        xd, yd = x.double(), y.double()
        for t, v in zip(stats, (xd.T @ xd, xd.T @ yd, xd.sum(0), yd.sum(), (yd * yd).sum(),
                                float(x.shape[0]))):
            t.add_(v)
    n = int(stats[5])
    return lr.finalize_normal_eq_stats(stats, reg, alpha, True, 500, 1e-6, n)


def phase_linreg(torch, kernels, lr, LinearRegression, config):
    """Phase 9; returns (bf16 batch, its y, f32 block, its y, launches)."""
    gen = torch.Generator(device=DEV).manual_seed(4)
    w = torch.randn((LR_D,), generator=gen, device=DEV) / LR_D ** 0.5
    parts = [lr_batch(torch, gen, LR_LAST_BATCH_ROWS if b == LR_BATCHES - 1 else BATCH_ROWS,
                      w, torch.bfloat16) for b in range(LR_BATCHES)]
    n_rows = sum(x.shape[0] for x, _ in parts)
    print(f"linreg stream: {LR_BATCHES} bf16 batches, {n_rows} rows x {LR_D}", flush=True)
    torch.cuda.synchronize()
    kernels.reset_launches()

    def stream_fit():
        st = lr.init_normal_eq_stats(LR_D, device=DEV)
        for x, y in parts:
            lr.streaming_normal_eq_update(st, x, y)
        return st, lr.finalize_normal_eq_stats(st, 0.0, 0.0, True, 500, 1e-6, n_rows)

    t0 = time.perf_counter()
    state, sol = stream_fit()
    fold_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    routes = dict(kernels.ROUTES)
    check(launches["linreg_stats"] == LR_BATCHES,
          f"linreg_stats launches {launches['linreg_stats']} == batches {LR_BATCHES}")
    check(routes["linreg_stats/wgmma"] == LR_BATCHES and routes["linreg_stats/ffma"] == 0,
          f"every linreg_stats launch of the stream took the tensor-core route: "
          f"{routes['linreg_stats/wgmma']} wgmma, {routes['linreg_stats/ffma']} ffma")
    print(f"linreg stream fit: {fold_s:.3f} s, {n_rows / fold_s:.1f} rows/s "
          f"(fold + Cholesky solve)", flush=True)
    device_breakdown(torch, "linreg stream fit trace (a second fit of the same batches)",
                     stream_fit, top=6)
    ref = lr_reference(torch, parts, lr)
    err = float(abs(sol.coefficients - ref.coefficients).max())
    b_err = abs(sol.intercept - ref.intercept)
    # Tolerance: float32 statistics (relative error about 1e-6) of a
    # well-conditioned system (XᵀX/n near the identity) move the solution
    # by about 1e-6; 1e-4 leaves room.
    check(err <= 1e-4 and b_err <= 1e-4,
          f"linreg stream vs float64 solve: coefficients max err {err:.3e}, intercept "
          f"{b_err:.3e} (tol 1e-4)")
    en = lr.finalize_normal_eq_stats(state, 0.01, 0.5, True, 500, 1e-6, n_rows)
    en_ref = lr_reference(torch, parts, lr, reg=0.01, alpha=0.5)
    err = float(abs(en.coefficients - en_ref.coefficients).max())
    # Tolerance: as above, plus FISTA's stop at an iterate movement of 1e-6.
    check(err <= 1e-4, f"linreg elastic net (reg 0.01, α 0.5) vs float64 FISTA: "
          f"coefficients max err {err:.3e} (tol 1e-4; {int((en.coefficients == 0).sum())} zeros)")
    xb, yb = parts[0]
    del parts, state

    x32, y32 = lr_batch(torch, gen, LR_IN_MEMORY_ROWS, w, torch.float32)
    kernels.reset_launches()
    t0 = time.perf_counter()
    with config.option("compute_dtype", "float32"):
        model = LinearRegression().fit({"features": x32, "label": y32})
    mem_s = time.perf_counter() - t0
    check(kernels.LAUNCHES["linreg_stats"] == 1 and kernels.ROUTES["linreg_stats/ffma"] == 1,
          f"linreg_stats launches {kernels.LAUNCHES['linreg_stats']} == 1 in the in-memory fit, "
          f"float32 on the FFMA route")
    print(f"linreg in-memory fit: {LR_IN_MEMORY_ROWS} x {LR_D} float32 in {mem_s:.3f} s, "
          f"{LR_IN_MEMORY_ROWS / mem_s:.1f} rows/s", flush=True)
    ref = lr_reference(torch, [(x32, y32)], lr)
    err = float(abs(model.coefficients - ref.coefficients).max())
    check(err <= 1e-4 and abs(model.intercept - ref.intercept) <= 1e-4,
          f"linreg in-memory vs float64 solve: coefficients max err {err:.3e} (tol 1e-4)")
    return xb, yb, x32, y32, launches


def phase_logreg_kernels(torch, kernels) -> None:
    """newton_stats and softmax_curvature against their plain versions at
    ragged shapes (n = 20,001 over 3 row splits, d = 300 over 3 tiles; and
    37 x 13), bf16 and f32, with and without a mask, C in {1, 3, 32}."""
    gen = torch.Generator(device=DEV).manual_seed(6)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        for n, d in ((20001, 300), (37, 13)):
            x = torch.randn((n, d), generator=gen, device=DEV).to(dtype)
            xf = x.float()
            y = (torch.rand((n,), generator=gen, device=DEV) < 0.5).float()
            w = torch.randn((d,), generator=gen, device=DEV) / d ** 0.5
            b = torch.tensor(0.3, device=DEV)
            for masked in (False, True):
                mask = (torch.rand((n,), generator=gen, device=DEV) < 0.7).float() if masked else None
                m = torch.ones((n,), device=DEV) if mask is None else mask
                # d = 300 and 13 are not multiples of 8: the FFMA route.
                out_k = routed(torch, kernels, "newton_stats", "ffma",
                               lambda: kernels.newton_stats(x, y, mask, w, b))
                out_p = kernels.newton_stats_plain(x, y, mask, w, b)
                torch.cuda.synchronize()
                # Tolerance: f32 sums in another order over <= 20,001 rows,
                # 1e-5 of each output's largest absolute sum of terms
                # (|r| <= 1 and wgt <= 1/4 per masked row).
                xa = xf.abs() * m[:, None]
                scales = (float(xa.sum(0).max()), float(m.sum()),
                          0.25 * float((xa * xf.abs()).sum(0).max()),
                          0.25 * float(xa.sum(0).max()), 0.25 * float(m.sum()))
                errs = [rel_err(a, c, max(sc, 1.0)) for a, c, sc in zip(out_k, out_p, scales)]
                names = ("Xᵀr", "Σr", "Xᵀdiag(wgt)X", "Xᵀwgt", "Σwgt")
                check(all(e <= 1e-5 for e in errs),
                      f"newton_stats {name} n={n} d={d} mask={masked} "
                      + ", ".join(f"{k} {e:.1e}" for k, e in zip(names, errs)))
            for c in (1, 3, 32):
                p = torch.softmax(torch.randn((n, c), generator=gen, device=DEV), dim=1)
                hk, bk = routed(torch, kernels, "softmax_curvature", "ffma",
                                lambda: kernels.softmax_curvature(x, p))
                hp, bp = kernels.softmax_curvature_plain(x, p)
                torch.cuda.synchronize()
                # Tolerance: as above; p_c <= 1, so Σx² and Σ|x| bound the terms.
                e_h = rel_err(hk, hp, max(float((xf * xf).sum(0).max()), 1.0))
                e_b = rel_err(bk, bp, max(float(xf.abs().sum(0).max()), 1.0))
                check(tuple(hk.shape) == (c, d, d) and tuple(bk.shape) == (c, d)
                      and e_h <= 1e-5 and e_b <= 1e-5,
                      f"softmax_curvature {name} n={n} d={d} C={c}: Xᵀdiag(p_c)X {e_h:.1e}, "
                      f"Xᵀp_c {e_b:.1e} (tol 1e-5)")


def binary_objective64(torch, x64, y64, w, b, reg) -> float:
    z = x64 @ w + b
    loss = (torch.logaddexp(z, torch.zeros_like(z)) - y64 * z).mean()
    return float(loss) + 0.5 * reg * float(w @ w)


def binary_reference(torch, x64, y64, reg):
    """Float64 Newton on the card, the bordered (d + 1) system solved
    directly, to a step of 1e-12: the optimum the fit is held to."""
    n, d = x64.shape
    w = torch.zeros((d,), dtype=torch.float64, device=DEV)
    b = torch.zeros((), dtype=torch.float64, device=DEV)
    eye = torch.eye(d, dtype=torch.float64, device=DEV)
    for it in range(1, 51):
        p = torch.sigmoid(x64 @ w + b)
        wgt = p * (1.0 - p)
        h = torch.empty((d + 1, d + 1), dtype=torch.float64, device=DEV)
        h[:d, :d] = (x64 * wgt[:, None]).T @ x64 / n + reg * eye
        h[:d, d] = h[d, :d] = x64.T @ wgt / n
        h[d, d] = wgt.sum() / n
        g = torch.cat([x64.T @ (p - y64) / n + reg * w, ((p - y64).sum() / n)[None]])
        step = torch.linalg.solve(h, g)
        w, b = w - step[:d], b - step[d]
        if float(torch.linalg.norm(step)) <= 1e-12:
            break
    return w, b, it


def phase_logreg_binary(torch, kernels, lg, LogisticRegression):
    """Phase 11; returns (x, y, model, launches)."""
    gen = torch.Generator(device=DEV).manual_seed(7)
    x = torch.randn((LG_ROWS, LG_D), generator=gen, device=DEV).to(torch.bfloat16)
    w_true = torch.randn((LG_D,), generator=gen, device=DEV) / LG_D ** 0.5
    # Noisy labels (Bernoulli of the true probabilities): a well-posed
    # optimum, where bench_logreg.py's thresholded labels are separable.
    p_true = torch.sigmoid(x.float() @ w_true + 0.3)
    y = (torch.rand((LG_ROWS,), generator=gen, device=DEV) < p_true).float()
    del p_true
    print(f"logreg binary: {LG_ROWS} x {LG_D} bf16 rows, regParam {LG_REG}, maxIter 100, "
          f"tol 1e-6", flush=True)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    model = LogisticRegression().setRegParam(LG_REG).fit({"features": x, "label": y})
    fit_s = time.perf_counter() - t0  # the coefficients are on the host: synced
    launches = dict(kernels.LAUNCHES)
    routes = dict(kernels.ROUTES)
    it = model.summary.numIter
    check(launches["newton_stats"] == it,
          f"newton_stats launches {launches['newton_stats']} == numIter {it}")
    check(routes["newton_stats/wgmma"] == it and routes["newton_stats/ffma"] == 0,
          f"every newton_stats launch of the fit took the tensor-core route: "
          f"{routes['newton_stats/wgmma']} wgmma, {routes['newton_stats/ffma']} ffma")
    print(f"logreg binary fit: {fit_s:.3f} s, {it} Newton iterations, "
          f"{LG_ROWS * it / fit_s:.1f} row-iterations/s (host clock, ends on a host read)",
          flush=True)
    device_breakdown(torch, "logreg binary fit trace (a second fit of the same rows)",
                     lambda: LogisticRegression().setRegParam(LG_REG).fit(
                         {"features": x, "label": y}), top=6)
    x64, y64 = x.double(), y.double()
    w_ref, b_ref, ref_it = binary_reference(torch, x64, y64, LG_REG)
    w = torch.as_tensor(model.coefficients, device=DEV)
    b = float(model.intercept)
    wn = float(torch.linalg.norm(w_ref))
    err_w = float(torch.linalg.norm(w - w_ref)) / wn
    err_b = abs(b - float(b_ref)) / wn
    # Tolerance (relative to ‖w‖): the fit stops at a step of 2⁻⁸·‖w‖ on
    # bf16 rows; its gradient is exact to f32 on those rows, so the
    # remaining error is Newton's quadratic contraction of that step and
    # the f32 statistics. 1e-4 was expected and 2⁻⁸ is the hard limit; the
    # first chip run measured 1.1e-7 and 2.4e-9, so 1e-5.
    check(err_w <= 1e-5 and err_b <= 1e-5,
          f"logreg binary vs float64 Newton ({ref_it} steps to 1e-12) on the same bf16 rows: "
          f"‖Δw‖/‖w‖ {err_w:.3e}, |Δb|/‖w‖ {err_b:.3e} (tol 1e-5; ‖w‖ {wn:.4f})")
    f_port = binary_objective64(torch, x64, y64, w, b, LG_REG)
    f_ref = binary_objective64(torch, x64, y64, w_ref, b_ref, LG_REG)
    gap = (f_port - f_ref) / abs(f_ref)
    check(abs(gap) <= 1e-6, f"logreg binary float64 objective {f_port:.10f} vs optimum "
          f"{f_ref:.10f}: rel gap {gap:.3e} (tol 1e-6)")
    del x64, y64
    return x, y, model, launches


def softmax_reference(torch, kernels, x64, xh, xh64, yi, reg, passes, rounded):
    """The fit's MM-Newton passes in float64 on the card: logits and
    gradient on x64, per-class curvature on the bf16 rows xh (xh64 in
    float64) — with ``rounded``, of the operand the tensor-core route
    rounds, bf16(xh·bf16(p_c)), its lower tiles mirrored as the SYRK
    writes them; else of xh·p_c — its border xhᵀp_c, and bordered
    per-class systems solved directly."""
    n, d = x64.shape
    c = int(yi.max()) + 1
    W = torch.zeros((d, c), dtype=torch.float64, device=DEV)
    b = torch.zeros((c,), dtype=torch.float64, device=DEV)
    onehot = torch.nn.functional.one_hot(yi, c).double()
    for _ in range(passes):
        p = torch.softmax(x64 @ W + b, dim=1)
        gw = (x64.T @ (p - onehot) / n + reg * W).T  # (C, d)
        gb = (p - onehot).sum(0) / n
        h = torch.zeros((c, d + 1, d + 1), dtype=torch.float64, device=DEV)
        for k in range(c):
            if rounded:
                h[k, :d, :d] = syrk_emulation(torch, kernels, xh, p[:, k], xh64) / n
            else:
                h[k, :d, :d] = (xh64 * p[:, k:k + 1]).T @ xh64 / n
            h[k, :d, d] = h[k, d, :d] = xh64.T @ p[:, k] / n
        h[:, :d, :d] += reg * torch.eye(d, dtype=torch.float64, device=DEV)
        h[:, d, d] = p.sum(0) / n
        step = torch.linalg.solve(h, torch.cat([gw, gb[:, None]], dim=1))
        W, b = W - step[:, :d].T, b - step[:, d]
    return W, b


def phase_logreg_multinomial(torch, kernels, lg, LogisticRegression, config):
    """Phase 12; returns (x, bf16 x, y, model, probabilities, launches)."""
    gen = torch.Generator(device=DEV).manual_seed(8)
    x = torch.randn((MN_ROWS, LG_D), generator=gen, device=DEV)
    w_true = torch.randn((LG_D, MN_CLASSES), generator=gen, device=DEV) / LG_D ** 0.5
    b_true = 0.5 * torch.randn((MN_CLASSES,), generator=gen, device=DEV)
    p_true = torch.softmax(x @ w_true + b_true, dim=1)
    y = torch.multinomial(p_true, 1, generator=gen)[:, 0].float()
    del p_true
    print(f"logreg multinomial: {MN_ROWS} x {LG_D} float32 rows, C={MN_CLASSES}, regParam "
          f"{LG_REG}, maxIter {MN_PASSES}, tol 0", flush=True)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    model = (LogisticRegression().setRegParam(LG_REG).setMaxIter(MN_PASSES).setTol(0.0)
             .fit({"features": x, "label": y}))
    fit_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    routes = dict(kernels.ROUTES)
    check(launches["softmax_curvature"] == MN_PASSES,
          f"softmax_curvature launches {launches['softmax_curvature']} == passes {MN_PASSES}")
    check(routes["softmax_curvature/wgmma"] == MN_PASSES and routes["softmax_curvature/ffma"] == 0,
          f"every softmax_curvature launch of the fit took the tensor-core route: "
          f"{routes['softmax_curvature/wgmma']} wgmma, {routes['softmax_curvature/ffma']} ffma")
    hist = model.summary.objectiveHistory
    print(f"logreg multinomial fit: {fit_s:.3f} s, {model.summary.numIter} passes, "
          f"{MN_ROWS * model.summary.numIter / fit_s:.1f} row-iterations/s; objective per "
          f"pass {', '.join(f'{v:.8f}' for v in hist)}", flush=True)
    check(len(hist) == MN_PASSES and all(b <= a * (1 + 1e-6) for a, b in zip(hist, hist[1:])),
          "multinomial objective does not increase from pass to pass (MM descent, 1e-6 rel)")
    device_breakdown(torch, "logreg multinomial fit trace (a second fit of the same rows)",
                     lambda: LogisticRegression().setRegParam(LG_REG).setMaxIter(MN_PASSES)
                     .setTol(0.0).fit({"features": x, "label": y}), top=8)
    xh = x.to(config.compute_dtype(DEV))
    x64, xh64 = x.double(), xh.double()
    yi = y.long()
    # The reference rounds the curvature operand as the fit's tensor-core
    # route does (bf16(xh·bf16(p_c)), lower tiles mirrored); the same
    # passes with the unrounded operand show what that rounding moves.
    W_ref, b_ref = softmax_reference(torch, kernels, x64, xh, xh64, yi, LG_REG, MN_PASSES, True)
    W_u, b_u = softmax_reference(torch, kernels, x64, xh, xh64, yi, LG_REG, MN_PASSES, False)
    W = torch.as_tensor(model.coefficients.T, device=DEV)
    b = torch.as_tensor(model.intercept, device=DEV)
    scale = float(W_ref.abs().max())
    err_w = float((W - W_ref).abs().max()) / scale
    err_b = float((b - b_ref).abs().max()) / scale
    # Tolerance: float32 statistics (relative error about 1e-6) through
    # five MM steps; the intercepts' gradient Σr cancels more. The first
    # chip run measured 2.7e-6 and 7.3e-5 of max|W|: 3e-5 and 1e-3.
    check(err_w <= 3e-5 and err_b <= 1e-3,
          f"multinomial (W, b) vs the same {MN_PASSES} passes in float64: max err W "
          f"{err_w:.3e} (tol 3e-5), b {err_b:.3e} (tol 1e-3) of max|W| {scale:.4f}")
    print(f"multinomial (W, b) vs the same passes with the unrounded curvature operand: max "
          f"err W {float((W - W_u).abs().max()) / scale:.3e}, b "
          f"{float((b - b_u).abs().max()) / scale:.3e} of max|W|; the two float64 references "
          f"differ by {float((W_ref - W_u).abs().max()) / scale:.3e} in W", flush=True)
    del W_u, b_u
    # One pass's statistics at the final iterate against float64.
    Wf, bf = W.float(), b.float()
    state = lg.stream_softmax_zero_state(LG_D, MN_CLASSES, torch.float32, DEV)
    lg.softmax_stats_update(state, Wf, bf, x, y, xh=xh)
    p64 = torch.softmax(x64 @ Wf.double() + bf.double(), dim=1)
    r64 = p64 - torch.nn.functional.one_hot(yi, MN_CLASSES).double()
    gw64 = x64.T @ r64
    e_g_max = rel_err(state[0], gw64, float(gw64.abs().max()))
    e_g = rel_err(state[0], gw64, float((x64.abs().T @ r64.abs()).max()))
    del r64
    hw_err, hw_err_u, hw_max = 0.0, 0.0, 0.0
    for k in range(MN_CLASSES):
        hk = syrk_emulation(torch, kernels, xh, p64[:, k], xh64)
        hw_err = max(hw_err, float((state[2][k].double() - hk).abs().max()))
        hk = (xh64 * p64[:, k:k + 1]).T @ xh64
        hw_err_u = max(hw_err_u, float((state[2][k].double() - hk).abs().max()))
        hw_max = max(hw_max, float(hk.abs().max()))
    e_h = hw_err / hw_max
    # Tolerances: the gradient within 1e-5 of its largest absolute sum of
    # terms Σ|x||r| (the f32 logits carry about 1e-7·Σ|x||W| into every r,
    # and that sums over the rows, so the largest entry, a sum with
    # cancellation, is no scale for it; the error over it is printed); the
    # curvature within 1e-4 of its largest entry, against float64 of the
    # rounded operand (against the unrounded one, printed, the rounding's
    # own 2⁻⁸/√n-sized difference adds).
    check(e_g <= 1e-5 and e_h <= 1e-4,
          f"multinomial pass statistics at the final iterate vs float64: gradient {e_g:.3e} "
          f"of max Σ|x||r| (tol 1e-5; {e_g_max:.3e} of its largest entry), curvature "
          f"{e_h:.3e} of its largest entry (tol 1e-4; {hw_err_u / hw_max:.3e} against the "
          f"unrounded operand)")
    p = torch.softmax(x @ Wf + bf, dim=1)
    del x64, xh64, state, hk
    return x, xh, y, model, p, launches


def check_transform(torch, model, xq, cd, tag) -> float:
    """rawPrediction and probability of ``transform_matrix`` against
    float64 at the compute-dtype-rounded x and coefficients; returns the
    p50 latency in ms of 21 runs."""
    out = model.transform_matrix(xq)
    coef = torch.as_tensor(model.coefficients, device=DEV).to(cd).double()
    inter = torch.as_tensor(model.intercept, device=DEV).double()
    xd = xq.to(cd).double()
    z = xd @ coef.reshape(-1, LG_D).T + inter.reshape(1, -1)
    raw64 = torch.cat([-z, z], dim=1) if model.coefficients.ndim == 1 else z
    scale = float((xd.abs() @ coef.reshape(-1, LG_D).abs().T).max()) + float(inter.abs().max())
    raw_err = float((out["rawPrediction"] - raw64).abs().max())
    if model.coefficients.ndim == 1:
        proba64 = torch.sigmoid(raw64[:, 1])
        proba64 = torch.stack([1 - proba64, proba64], dim=1)
    else:
        proba64 = torch.softmax(raw64, dim=1)
    p_err = float((out["probability"] - proba64).abs().max())
    # Tolerance: the same rounded operands summed in f32 over 1024 terms,
    # 1e-5 of the largest Σ|x||w|; a probability moves at most as much.
    check(raw_err <= 1e-5 * scale and p_err <= 1e-5 * scale,
          f"{tag} transform vs float64: rawPrediction err {raw_err:.3e}, probability "
          f"{p_err:.3e} (tol 1e-5 x {scale:.2f})")
    top2 = raw64.topk(2, dim=1).values
    tie_band = max(1e-6, 2 * raw_err)  # a smaller gap can flip under that error
    differ = out["prediction"] != raw64.argmax(dim=1).double()
    near = (top2[:, 0] - top2[:, 1]) <= tie_band
    check(bool((~differ | near).all()),
          f"{tag} predictions equal float64's except at {int(differ.sum())} rows within "
          f"{tie_band:.1e} of a tie ({int(near.sum())} such rows)")
    lat = []
    for _ in range(21):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.transform_matrix(xq)["prediction"].sum().item()
        lat.append((time.perf_counter() - t0) * 1e3)
    lat.sort()
    return lat[len(lat) // 2]


def kernel_times(torch, fn, reps) -> dict:
    """Device ms per call of each kernel ``fn`` launches, by kernel name,
    from a torch.profiler trace of ``reps`` calls after a warm-up."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(
                e, "is_user_annotation", False):
            out[e.name] = out.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
    return out


def ms_of(times: dict, name: str) -> str:
    """The summed ms of the kernels whose names hold ``name``, or "not
    measured" when the trace has none."""
    hits = [t for k, t in times.items() if name in k]
    return f"{sum(hits):.3f} ms" if hits else "not measured"


def ffma_newton(torch, kernels, x, y, w, b):
    """newton_stats through the FFMA body's entry point on bf16 rows (the
    wrapper routes them to the tensor cores): the earlier design, timed."""
    n, d = x.shape
    z = lambda *shape: torch.zeros(shape, device=DEV)  # noqa: E731
    outs = (z(n), z(n), z(d), z(), z(d, d), z(d), z())
    rc = kernels._lib().srml_newton_stats(
        x.data_ptr(), 1, y.data_ptr(), None, w.data_ptr(), b.data_ptr(), n, d,
        *kernels._ffma_plan_args(x, n), *(t.data_ptr() for t in outs),
        torch.cuda.current_stream().cuda_stream)
    if rc:
        fail(f"FFMA newton_stats launch rc {rc}")


def ffma_softmax(torch, kernels, x, p):
    """softmax_curvature through the FFMA body's entry point on bf16 rows."""
    n, d = x.shape
    c = p.shape[1]
    hw = torch.zeros((c, d, d), device=DEV)
    hwb = torch.zeros((c, d), device=DEV)
    rc = kernels._lib().srml_softmax_curvature(x.data_ptr(), 1, p.data_ptr(), n, d, c,
                                                *kernels._ffma_plan_args(x, n, c),
                                                hw.data_ptr(), hwb.data_ptr(),
                                                torch.cuda.current_stream().cuda_stream)
    if rc:
        fail(f"FFMA softmax_curvature launch rc {rc}")


def phase_logreg_timings(torch, kernels, solve_newton_system, xl, yl, model_b, lg_launches,
                         xmh, pm, mn_launches):
    """Phase 14: the two kernel rows at the phase 11 and 12 shapes (the
    Newton row pass and Gram pass apart, each kernel's promotion sweep
    against float64 of its own rounding), and the time of the Newton
    solve."""
    rows = []
    n, d = xl.shape
    w = torch.as_tensor(model_b.coefficients, device=DEV).float()
    b = torch.tensor(float(model_b.intercept), device=DEV)
    ms = time_ms(lambda: kernels.newton_stats(xl, yl, None, w, b), 10)
    plain_ms = time_ms(lambda: kernels.newton_stats_plain(xl, yl, None, w, b), 3)
    split = kernel_times(torch, lambda: kernels.newton_stats(xl, yl, None, w, b), 10)
    out_k = kernels.newton_stats_launch(xl, yl, None, w, b)
    out_p = kernels.newton_stats_plain(xl, yl, None, w, b)
    # Yardstick: no PyTorch call computes the pass; the Hessian product
    # alone, (x·wgt)ᵀx in bf16 (tensor cores), is timed.
    xw = (xl * out_k[6].to(torch.bfloat16)[:, None])
    lib_ms = time_ms(lambda: torch.matmul(xw.T, xl), 5)
    del xw
    hscale = float(out_p[2].diagonal().max())  # the largest Σ|terms| (Cauchy–Schwarz)
    err = rel_err(out_k[2], syrk_emulation(torch, kernels, xl, out_k[6]), hscale)
    err_p = rel_err(out_k[2], out_p[2], hscale)
    gerr = rel_err(out_k[0], out_p[0], float(xl.float().abs().sum(0).max()))
    # Tolerance: f32 sums over 511,943 rows in another order, 1e-4
    # relative, against the emulation of the route's rounding; the plain
    # (f32-weighted) version within the rounding bound.
    check(err <= 1e-4 and err_p <= ROUNDING_BOUND and gerr <= 1e-4,
          f"newton_stats at {n} x {d} bf16: Hessian vs its rounding emulated {err:.2e} (tol "
          f"1e-4), vs plain {err_p:.2e} (tol 2^-8), gradient {gerr:.2e} (tol 1e-4)")
    # The row pass reads x, y and w and writes r and wgt: its byte bound.
    row_bound = (n * d * 2 + n * 12 + d * 4) / PEAK_BYTES_PER_S * 1e3
    # Beside it, in this call: the FFMA body on the same bf16 rows (the
    # route before the tensor-core redesign) and the unweighted tensor-core
    # body at the same shape (what the weighting costs).
    ffma_ms = time_ms(lambda: ffma_newton(torch, kernels, xl, yl, w, b), 3)
    colsum_ms = time_ms(lambda: kernels.gram_colsum(xl, n), 10)
    print(f"newton_stats at {n} x {d}: {ms:.3f} ms a call; trace: row pass "
          f"{ms_of(split, 'newton_row_kernel')} (byte bound {row_bound:.3f} ms), Gram pass "
          f"{ms_of(split, 'gram_tc_kernel')} (0.604 TFLOP of wgmma); the FFMA body on the same "
          f"rows {ffma_ms:.3f} ms; the unweighted gram_colsum at this shape {colsum_ms:.3f} ms; "
          f"the plain version {plain_ms:.3f} ms", flush=True)
    x64 = xl.double()
    h64 = syrk_emulation(torch, kernels, xl, out_k[6], x64)
    del x64
    promote_sweep(torch, kernels, lambda: kernels.newton_stats(xl, yl, None, w, b),
                  lambda: kernels.newton_stats(xl, yl, None, w, b)[2], h64, hscale,
                  f"newton_stats {n} x {d} (Hessian vs float64 of its rounding)")
    del h64
    # Bound: x, y, w and b read once, the five outputs written once; the
    # Hessian is symmetric, so nd(d+1) operations, plus 6nd for x·w, Xᵀr and
    # Xᵀwgt.
    b_ms, b_by = bound_ms(n * d * 2 + n * 4 + d * 4 + 4 + 4 * (d * d + 2 * d + 2),
                          n * d * (d + 1) + 6 * n * d, "bfloat16")
    rows.append({
        "name": "newton_stats", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES["newton_stats"], "launches": lg_launches["newton_stats"],
        "max_abs_err": float((out_k[2] - out_p[2]).abs().max()),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms,
    })
    # The Newton solve of the phase-11 system: the port's bordered solve
    # (reg > 0: a d-square Cholesky with two right-hand sides) and a bare
    # Cholesky factor and solve of the whole (d + 1)-square system.
    nf = float(n)
    eye = torch.eye(d, device=DEV)
    hww, hwb, hbb = out_k[2] / nf + LG_REG * eye, out_k[3] / nf, out_k[4] / nf
    gw, gb = out_k[0] / nf + LG_REG * w, out_k[1] / nf
    solve_ms = time_ms(lambda: solve_newton_system(hww, hwb, hbb, gw, gb, LG_REG, True), 5)
    hfull = torch.empty((d + 1, d + 1), device=DEV)
    hfull[:d, :d], hfull[:d, d], hfull[d, :d], hfull[d, d] = hww, hwb, hwb, hbb
    gfull = torch.cat([gw, gb[None]])[:, None]
    chol_ms = time_ms(lambda: torch.cholesky_solve(gfull, torch.linalg.cholesky_ex(hfull)[0]), 5)
    print(f"Newton solve at d={d} f32: solve_newton_system {solve_ms:.3f} ms, "
          f"(d+1)-square cholesky_ex + cholesky_solve {chol_ms:.3f} ms", flush=True)
    del out_k, out_p

    n, d = xmh.shape
    c = pm.shape[1]
    ms = time_ms(lambda: kernels.softmax_curvature(xmh, pm), 10)
    plain_ms = time_ms(lambda: kernels.softmax_curvature_plain(xmh, pm), 2)
    hk, bk = kernels.softmax_curvature(xmh, pm)
    hp, bp = kernels.softmax_curvature_plain(xmh, pm)
    hscale = float(hp.diagonal(dim1=1, dim2=2).max())
    err = max(rel_err(hk[k], syrk_emulation(torch, kernels, xmh, pm[:, k]), hscale)
              for k in range(c))
    err_p = rel_err(hk, hp, hscale)
    berr = rel_err(bk, bp, float(xmh.float().abs().sum(0).max()))
    # Tolerance: f32 sums over 129,838 rows in another order, 1e-4
    # relative, against the emulation of the route's rounding; the plain
    # version within the rounding bound.
    check(err <= 1e-4 and err_p <= ROUNDING_BOUND and berr <= 1e-4,
          f"softmax_curvature at {n} x {d} bf16, C={c}: curvature vs its rounding emulated "
          f"{err:.2e} (tol 1e-4), vs plain {err_p:.2e} (tol 2^-8), border {berr:.2e} (tol 1e-4)")
    max_err = float((hk - hp).abs().max())
    del hp, bp
    xm64 = xmh.double()
    h64 = torch.stack([syrk_emulation(torch, kernels, xmh, pm[:, k], xm64) for k in range(c)])
    del xm64
    promote_sweep(torch, kernels, lambda: kernels.softmax_curvature(xmh, pm),
                  lambda: kernels.softmax_curvature(xmh, pm)[0], h64, hscale,
                  f"softmax_curvature {n} x {d} C={c} (curvature vs float64 of its rounding)")
    del h64
    ffma_ms = time_ms(lambda: ffma_softmax(torch, kernels, xmh, pm), 2)
    colsum_ms = time_ms(lambda: kernels.gram_colsum(xmh, n), 10)
    print(f"softmax_curvature at {n} x {d}, C={c}: {ms:.3f} ms a call; the FFMA body on the "
          f"same rows {ffma_ms:.3f} ms; {c} x the unweighted gram_colsum at this shape "
          f"{c * colsum_ms:.3f} ms", flush=True)
    # Yardstick: C Hessian products alone, (x·p_c)ᵀx in bf16, timed as C
    # products of one weighted copy (the same work per product).
    xw = (xmh.float() * pm[:, :1]).to(torch.bfloat16)
    lib_ms = time_ms(lambda: [torch.matmul(xw.T, xmh) for _ in range(c)], 3)
    del xw
    # Bound: x and p read once, the (C, d, d) and (C, d) outputs written
    # once; C·nd(d+1) operations for the symmetric blocks and 2Cnd for Xᵀp_c.
    b_ms, b_by = bound_ms(n * d * 2 + n * c * 4 + 4 * c * (d * d + d),
                          c * n * d * (d + 1) + 2 * c * n * d, "bfloat16")
    rows.append({
        "name": "softmax_curvature", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES["softmax_curvature"],
        "launches": mn_launches["softmax_curvature"],
        "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms,
    })
    return rows


def knn_data(torch, gen, rows, centers):
    """bench_knn.py's mixture: a centre drawn uniformly, plus KNN_SPREAD ·
    N(0, 1) per coordinate; f32, made in 1M-row chunks."""
    out = torch.empty((rows, KNN_D), dtype=torch.float32, device=DEV)
    for r0 in range(0, rows, 1 << 20):
        m = min(rows, r0 + (1 << 20)) - r0
        lab = torch.randint(0, KNN_CLUSTERS, (m,), generator=gen, device=DEV)
        out[r0:r0 + m] = centers[lab] + KNN_SPREAD * torch.randn(
            (m, KNN_D), generator=gen, device=DEV)
    return out


def brute_force64(torch, db, qs, k):
    """Exact float64 ground truth over 65,536-row chunks: (d2 (q, k)
    ascending, ids (q, k)); torch.matmul in float64 is fine for a reference."""
    q64 = qs.double()
    q2 = (q64 * q64).sum(1)
    best_d = torch.empty((qs.shape[0], 0), dtype=torch.float64, device=DEV)
    best_i = torch.empty((qs.shape[0], 0), dtype=torch.int64, device=DEV)
    for r0 in range(0, db.shape[0], 1 << 16):
        c = db[r0:r0 + (1 << 16)].double()
        d2 = q2[:, None] + (c * c).sum(1)[None, :] - 2.0 * (q64 @ c.T)
        d, i = torch.topk(d2, k, dim=1, largest=False)
        cat_d, cat_i = torch.cat([best_d, d], 1), torch.cat([best_i, i + r0], 1)
        best_d, pos = torch.topk(cat_d, k, dim=1, largest=False)
        best_i = cat_i.gather(1, pos)
        order = torch.argsort(best_d, dim=1)
        best_d, best_i = best_d.gather(1, order), best_i.gather(1, order)
    return best_d, best_i


def recall_at(ids, gt) -> float:
    """Mean fraction of each query's true k neighbours found."""
    import numpy as np

    gt = gt.cpu().numpy()
    return float(np.mean([len(set(a) & set(b)) / gt.shape[1] for a, b in zip(ids, gt)]))


def p17_save(torch, ann, qs, gt_i, d_u, i_u, query_s, build_s) -> dict:
    """Phase 17's index written to a temporary directory (removed at exit)
    for phase 33b's ranks to memory-map, with its queries, its float64
    ground truth and its unsharded answer."""
    import atexit
    import shutil
    import tempfile

    import numpy as np

    tmpdir = tempfile.mkdtemp(prefix="srml_p17_")
    atexit.register(shutil.rmtree, tmpdir, True)
    t0 = time.perf_counter()
    for name, arr in ann.index._asdict().items():
        np.save(os.path.join(tmpdir, f"{name}.npy"), np.asarray(arr))
    np.save(os.path.join(tmpdir, "queries.npy"), torch.as_tensor(qs).cpu().numpy())
    save_s = time.perf_counter() - t0
    gb = sum(np.asarray(a).nbytes for a in ann.index) / 1e9
    print(f"ivf index written to disk for phase 33b: {gb:.2f} GB in {save_s:.3f} s", flush=True)
    return {"dir": tmpdir, "gt_i": gt_i.cpu(), "d": np.asarray(d_u), "i": np.asarray(i_u),
            "s": query_s, "build_s": build_s}


def check_selection(torch, tag, kd, ki, pd, pi, tol) -> int:
    """Kernel (kd, ki) against plain (pd, pi) selections, ascending per row:
    values within ``tol`` (a tensor broadcastable to them); where ids
    differ, the plain row must hold another value within tol of that slot's
    (a near-tie) or the slot must be the last. Returns the differing ids."""
    err = (kd.double() - pd.double()).abs()
    check(bool((err <= tol).all()), f"{tag}: values within tol (max err {float(err.max()):.3e})")
    diff = ki != pi
    if bool(diff.any()):
        prev = torch.cat([torch.full_like(pd[:, :1], float("inf")), pd[:, :-1]], 1)
        nxt = torch.cat([pd[:, 1:], torch.full_like(pd[:, :1], float("inf"))], 1)
        gap = torch.minimum((pd - prev).abs(), (nxt - pd).abs()).double()
        last = torch.zeros_like(diff)
        last[:, -1] = True
        ok = ~diff | last | (gap <= 2 * tol)
        check(bool(ok.all()), f"{tag}: {int(diff.sum())} differing ids, all at near-ties "
              f"or the last slot")
    print(f"ok    {tag}: {int((~diff).sum())} ids equal, {int(diff.sum())} differ at near-ties",
          flush=True)
    return int(diff.sum())


def device_time(torch, prof):
    """(busy ms, {name: (ms, count)}, device events) of a torch.profiler
    trace: busy is the union of the device events' intervals, without the
    trace spans' annotation ranges."""
    ev = sorted((e for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False)),
                key=lambda e: e.time_range.start)
    busy, end, by_name = 0.0, float("-inf"), {}
    for e in ev:
        start, stop = e.time_range.start, e.time_range.end
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (stop - start) / 1e3, n + 1)
    return busy / 1e3, by_name, ev


def device_breakdown(torch, tag, fn, top=5) -> None:
    """Prints one call's wall time, the device's busy and idle shares and
    its largest kernels, from a torch.profiler trace of CPU and CUDA
    activity: busy is the union of the device events' intervals, without
    the trace spans' annotation ranges."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy, by_name, ev = device_time(torch, prof)
    if busy == 0:
        print(f"{tag}: wall {wall:.3f} ms; device time not measured (no device activity traced)")
        return
    parts = ", ".join(f"{name[:48]} {t:.3f}"
                      for name, (t, _) in sorted(by_name.items(), key=lambda r: -r[1][0])[:top])
    print(f"{tag}: wall {wall:.3f} ms, device busy {busy:.3f} ms ({100 * busy / wall:.1f} %, idle "
          f"{100 * (1 - busy / wall):.1f} %) over {len(ev)} device events; largest (ms): {parts}",
          flush=True)


def phase_knn(torch, kernels, config):
    """Phases 15-18; returns the three kernel rows."""
    from spark_rapids_ml_tpu_torch import ApproximateNearestNeighbors, NearestNeighbors
    from spark_rapids_ml_tpu_torch.ops import selection as sel

    gen = torch.Generator(device=DEV).manual_seed(9)
    centers = torch.randn((KNN_CLUSTERS, KNN_D), generator=gen, device=DEV)
    x = knn_data(torch, gen, KNN_ROWS, centers)
    qs = knn_data(torch, gen, KNN_QUERIES, centers)
    del centers
    cd = config.compute_dtype(DEV)
    print(f"knn: {KNN_ROWS} x {KNN_D} rows of a {KNN_CLUSTERS}-component mixture (spread "
          f"{KNN_SPREAD}; depth cut from config #5's 10M), {KNN_QUERIES} queries, k={KNN_K}, "
          f"compute {str(cd)[6:]}", flush=True)

    # -- 16. exact NearestNeighbors -------------------------------------------------
    nn = NearestNeighbors().setK(KNN_K).fit({"features": x})
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    d_nn, i_nn = nn.kneighbors(qs)
    first_s = time.perf_counter() - t0
    nn_launches = dict(kernels.LAUNCHES)
    check(nn_launches["dist_topk"] == 1 and sum(nn_launches.values()) == 1
          and kernels.ROUTES["dist_topk/wgmma"] == 1,
          f"exact kneighbors: dist_topk launches {nn_launches['dist_topk']} == 1 on the "
          f"tensor-core route ({kernels.ROUTES['dist_topk/wgmma']}), no other kernel")
    t0 = time.perf_counter()
    nn.kneighbors(qs)
    nn_s = time.perf_counter() - t0
    INPROC_QPS["exact"] = KNN_QUERIES / nn_s
    device_breakdown(torch, "exact kneighbors trace", lambda: nn.kneighbors(qs))
    print(f"exact kneighbors: {KNN_QUERIES / nn_s:.1f} q/s ({nn_s:.3f} s for {KNN_QUERIES} "
          f"queries, index resident; first call with the index upload {first_s:.3f} s)",
          flush=True)
    xr, qr = x.to(cd), qs.to(cd)
    gt_d, gt_i = brute_force64(torch, xr, qr, KNN_K)
    q64 = qr.double()
    ids = torch.as_tensor(i_nn, device=DEV)
    got = torch.as_tensor(d_nn, device=DEV).double() ** 2
    rows64 = xr[ids.reshape(-1)].double().reshape(KNN_QUERIES, KNN_K, KNN_D)
    own64 = ((rows64 - q64[:, None, :]) ** 2).sum(2)
    del rows64
    # Tolerance: f32 sums of (q2 + r2) − 2q·r over 768 bf16 products whose
    # terms reach ‖q‖² + ‖r‖² (about 1.7e3 here): 4e-6 of the largest such
    # sum, about 1e-2 against within-cluster squared distances near 190.
    scale = float((q64 * q64).sum(1).max()) + float(kernels.row_sq_norms(xr).max())
    tol = 4e-6 * scale
    e_own = float((got - own64).abs().max())
    e_gt = float((got - gt_d).abs().max())
    same = float((ids == gt_i).float().mean())
    check(e_own <= tol and e_gt <= tol,
          f"exact vs float64 of the same bf16 rows: returned distances err {e_own:.3e}, "
          f"k smallest distances err {e_gt:.3e} (tol {tol:.2e}); ids equal to float64's "
          f"{same:.5f}, recall@{KNN_K} {recall_at(i_nn, gt_i):.5f}")
    del gt_d, gt_i, own64, got

    # -- 17. ApproximateNearestNeighbors ------------------------------------------------
    torch.cuda.synchronize()
    kernels.reset_launches()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        ann = (ApproximateNearestNeighbors().setK(KNN_K).setNlist(KNN_NLIST)
               .setNprobe(KNN_NPROBE).fit({"features": x}))
        build_s = time.perf_counter() - t0
    b_launches = dict(kernels.LAUNCHES)
    b_routes = dict(kernels.ROUTES)
    maxlen = ann.index.lists.shape[1]
    print(f"ivf build: {build_s:.3f} s, maxlen {maxlen} (cap {2 * KNN_ROWS // KNN_NLIST}), "
          f"launches lloyd_step {b_launches['lloyd_step']}, assign_min_dist "
          f"{b_launches['assign_min_dist']}, dist_topk {b_launches['dist_topk']}; of it "
          f"k-means init {span_seconds(prof, 'kmeans init'):.3f} s and Lloyd "
          f"{span_seconds(prof, 'lloyd'):.3f} s (host clock)", flush=True)
    check(b_launches["lloyd_step"] >= 1 and b_launches["assign_min_dist"] >= 1 + -(-KNN_ROWS // (1 << 18)),
          "ivf build: the quantizer's Lloyd steps and the chunked assignment ran on the kernels")
    check(b_routes["dist_topk/ffma"] == b_launches["dist_topk"] and b_routes["dist_topk/wgmma"] == 0,
          f"ivf build: its {b_launches['dist_topk']} f32 dist_topk launches (spill candidates) "
          "took the FFMA route")
    # The quantizer's fit scores bf16 rows (its Lloyd steps, two-pass at
    # k = 1,024 and d = 768, and its cost pass); the assignment chunks are f32.
    check(b_routes["lloyd_step/wgmma"] == b_launches["lloyd_step"]
          and b_routes["assign_min_dist/wgmma"] == 1
          and b_routes["assign_min_dist/ffma"] == b_launches["assign_min_dist"] - 1,
          "ivf build: every bf16 lloyd_step and assign_min_dist launch took the tensor-core "
          "route, the f32 chunks the FFMA route: "
          + str({k_: v for k_, v in b_routes.items() if k_.split('/')[0] in ('lloyd_step', 'assign_min_dist')}))
    gt_d, gt_i = brute_force64(torch, x, qs, KNN_K)
    captured = {}
    orig_probe, orig_scan = kernels.probe_select, kernels.ivf_scan_select

    def rec_probe(*a):
        captured["probe"] = a
        return orig_probe(*a)

    def rec_scan(*a):
        captured["scan"] = a
        return orig_scan(*a)

    ann.kneighbors(qs)  # warm-up: the index upload and its residual copy
    results, answers = {}, {}
    for rerank in (True, False):
        with config.option("ann_rerank", rerank):
            kernels.probe_select, kernels.ivf_scan_select = rec_probe, rec_scan
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            d_a, i_a = ann.kneighbors(qs)
            q_s = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
            scan_tc = kernels.ROUTES["ivf_scan_select/wgmma"]
            probe_fused = kernels.ROUTES["probe_select/fused"]
            kernels.probe_select, kernels.ivf_scan_select = orig_probe, orig_scan
            check(launches["probe_select"] == 1 and launches["ivf_scan_select"] == 1
                  and scan_tc == 1 and probe_fused == 1,
                  f"ivf kneighbors rerank={rerank}: probe_select {launches['probe_select']} == 1, "
                  f"fused ({probe_fused}); ivf_scan_select {launches['ivf_scan_select']} == 1, on "
                  f"the tensor-core route ({scan_tc})")
            rec = recall_at(i_a, gt_i)
            results[rerank] = (launches, captured.copy(), q_s, rec)
            answers[rerank] = (d_a, i_a)
            check(d_a.shape == (KNN_QUERIES, KNN_K) and bool(torch.isfinite(torch.as_tensor(d_a)).all()),
                  f"ivf rerank={rerank}: distances finite, shape {d_a.shape}")
            print(f"ivf kneighbors nprobe {KNN_NPROBE} rerank={rerank}: {KNN_QUERIES / q_s:.1f} q/s "
                  f"({q_s:.3f} s), recall@{KNN_K} {rec:.4f} vs float64 ground truth", flush=True)
    INPROC_QPS["ivf"] = KNN_QUERIES / results[True][2]
    device_breakdown(torch, f"ivf kneighbors nprobe {KNN_NPROBE} rerank=True trace",
                     lambda: ann.kneighbors(qs), top=10)
    ann._set(nprobe=KNN_NLIST)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    _, i_all = ann.kneighbors(qs)
    all_s = time.perf_counter() - t0
    rec_all = recall_at(i_all, gt_i)
    check(rec_all >= 0.98 and kernels.ROUTES["probe_select/sort"] == 1,
          f"ivf every list probed (nprobe {KNN_NLIST}): recall@{KNN_K} {rec_all:.4f} >= 0.98 "
          f"({all_s:.3f} s), its probe on the sort route "
          f"({kernels.ROUTES['probe_select/sort']})")
    # Phase 33b shards this index: written to disk once, with its answer.
    P17_INDEX.update(p17_save(torch, ann, qs, gt_i, *answers[True], results[True][2],
                              build_s))
    del gt_d, gt_i, i_all

    # -- 15. kernels against their plain versions at the path's shapes -------------------
    db_c, row_ids, mask, r2_c = nn._ensure_index(torch.device(DEV), cd)  # phase 16's index
    q_c = qs.to(cd)
    kd, ki = kernels.dist_topk(q_c, db_c, row_ids, mask, KNN_K, r2_c)
    pd, pi = kernels.dist_topk_plain(q_c, db_c, row_ids, mask, KNN_K, r2_c)
    check_selection(torch, f"dist_topk {KNN_QUERIES} x {KNN_ROWS} x {KNN_D} {str(cd)[6:]} "
                    f"k={KNN_K} (tol {tol:.2e})", kd, ki, pd, pi, tol)
    dk_err = float((kd - pd).abs().max())
    cent = torch.as_tensor(ann.index.centroids, device=DEV).float().contiguous()
    chunk = x[:1 << 18].contiguous()
    lists = torch.arange(KNN_NLIST, dtype=torch.int32, device=DEV)
    ones = torch.ones((KNN_NLIST,), device=DEV)
    bd, bi = kernels.dist_topk(chunk, cent, lists, ones, 4)
    bpd, bpi = kernels.dist_topk_plain(chunk, cent, lists, ones, 4)
    # Tolerance: f32 products of f32 values, 4e-6 of the norms' sum.
    btol = 4e-6 * (float(kernels.row_sq_norms(chunk).max()) + float(kernels.row_sq_norms(cent).max()))
    check_selection(torch, f"dist_topk {1 << 18} x {KNN_NLIST} x {KNN_D} f32 k=4 (the build's "
                    f"spill candidates; tol {btol:.2e})", bd, bi, bpd, bpi, btol)
    cent_p, q_p, nprobe = results[True][1]["probe"]
    kp, kdd = kernels.probe_select(cent_p, q_p, nprobe)
    pp, pdd = kernels.probe_select_plain(cent_p, q_p, nprobe)
    pbits = sel.pos_bits_for(KNN_NLIST)
    # Tolerance: the packed-key floor (2^(pos_bits − 23) of the value: the
    # two sides may floor on either side of a step) plus f32 sums, 4e-6 of
    # ‖q‖² + ‖c‖².
    ptol = 2.0 ** (pbits - 23) * pdd.abs() + 4e-6 * (
        float(kernels.row_sq_norms(q_p).max()) + float(kernels.row_sq_norms(cent_p).max()))
    check_selection(torch, f"probe_select {q_p.shape[0]} x {KNN_NLIST} x {KNN_D} nprobe "
                    f"{nprobe} (tol floor + {float(ptol.min()):.2e})", kdd, kp, pdd, pp, ptol)
    qv, rows, r2, blk_k = results[True][1]["scan"]
    sd, sp = kernels.ivf_scan_select(qv, rows, r2, blk_k)
    spd, spp = kernels.ivf_scan_select_plain(qv, rows, r2, blk_k)
    sbits = sel.pos_bits_for(rows.shape[1])
    q2 = kernels.row_sq_norms(qv.reshape(-1, KNN_D)).max()
    r2max = float(torch.where(r2 < 1e29, r2, 0).max())
    # Tolerance: the floor, plus f32 sums of r2 − 2·qv·row: 4e-6 of
    # r2 + ‖qv‖² + ‖row‖² bounds.
    stol = 2.0 ** (sbits - 23) * spd.abs() + 4e-6 * (2 * r2max + float(q2))
    flat = lambda t: t.permute(0, 2, 1).reshape(-1, t.shape[1])[:, :blk_k]  # noqa: E731
    check_selection(torch, f"ivf_scan_select {tuple(qv.shape)} x maxlen {rows.shape[1]} "
                    f"blk_k {blk_k}", flat(sd), flat(sp), flat(spd), flat(spp), flat(stol))

    # -- 18. kernel times ----------------------------------------------------------------
    rows_t = []
    n, m, d = q_c.shape[0], db_c.shape[0], KNN_D
    # The main path's call (r2 from the index) on its tensor-core route;
    # beside it the FFMA tiles on the same inputs, the route before this
    # body (topk_route forced to "ffma" for the call).
    ms = time_ms(lambda: kernels.dist_topk(q_c, db_c, row_ids, mask, KNN_K, r2_c), 3)
    route_fn = kernels.topk_route
    kernels.topk_route = lambda *a: "ffma"
    try:
        ffma_ms = time_ms(lambda: kernels.dist_topk(q_c, db_c, row_ids, mask, KNN_K, r2_c), 1)
    finally:
        kernels.topk_route = route_fn
    plain_ms = time_ms(lambda: kernels.dist_topk_plain(q_c, db_c, row_ids, mask, KNN_K, r2_c), 1)

    def lib_topk(sort):
        # Library routes: bf16 torch.matmul per 131,072-row chunk, merged
        # into the running best by a stable torch.sort (as the plain version
        # merges) or by torch.topk (no tie order: a time yardstick only).
        best_d = torch.empty((n, 0), dtype=q_c.dtype, device=DEV)
        best_i = torch.empty((n, 0), dtype=torch.int64, device=DEV)
        for r0 in range(0, m, 1 << 17):
            s_ = torch.matmul(q_c, db_c[r0:r0 + (1 << 17)].T)
            if sort:
                cat_d = torch.cat([best_d, -s_], 1)
                o = torch.sort(cat_d, dim=1, stable=True).indices[:, :KNN_K]
                best_i = torch.cat([best_i, torch.arange(r0, r0 + s_.shape[1], device=DEV)
                                    .expand(n, -1)], 1).gather(1, o)
            else:
                v, i = torch.topk(-s_, KNN_K, dim=1, largest=False)
                cat_d = torch.cat([best_d, v], 1)
                o = torch.topk(cat_d, KNN_K, dim=1, largest=False).indices
                best_i = torch.cat([best_i, i + r0], 1).gather(1, o)
            best_d = cat_d.gather(1, o)
        return best_d, best_i
    lib_ms = time_ms(lambda: lib_topk(True), 1)
    lib_topk_ms = time_ms(lambda: lib_topk(False), 1)
    # The epilogue's share: the same body at k = 1 and at the route's limit.
    for k_ in (1, kernels.TOPK_TC_MAX_K):
        ms_k = time_ms(lambda: kernels.dist_topk(q_c, db_c, row_ids, mask, k_, r2_c), 2)
        print(f"dist_topk wgmma at k={k_}: {ms_k:.3f} ms", flush=True)
    b_ms, b_by = bound_ms(n * d * 2 + m * d * 2 + m * 8 + n * KNN_K * 8, 2 * n * m * d, "bfloat16")
    rows_t.append({
        "name": "dist_topk", "route": "cuda", "source": KNN_SOURCE,
        "replaces": REPLACES["dist_topk"], "launches": nn_launches["dist_topk"],
        "max_abs_err": dk_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": lib_ms, "library_topk_ms": lib_topk_ms,
        "ffma_ms": ffma_ms,
    })
    print(f"dist_topk at {n} x {m} x {d} bf16, k={KNN_K}: wgmma {ms:.3f} ms, the FFMA tiles "
          f"{ffma_ms:.3f} ms; library: matmul + stable sort {lib_ms:.3f} ms, matmul + topk "
          f"{lib_topk_ms:.3f} ms; bound {b_ms:.3f} by {b_by}", flush=True)
    del db_c, pd, pi, kd, ki, nn, r2_c
    torch.cuda.empty_cache()
    # The build's spill candidates (f32, k = 4, its FFMA route), timed at
    # one chunk of the build.
    ms_b = time_ms(lambda: kernels.dist_topk(chunk, cent, lists, ones, 4), 3)
    b_b, by_b = bound_ms(chunk.numel() * 4 + cent.numel() * 4 + KNN_NLIST * 8 + chunk.shape[0] * 32,
                         2 * chunk.shape[0] * KNN_NLIST * d, "float32")
    print(f"dist_topk ffma at {chunk.shape[0]} x {KNN_NLIST} x {d} f32, k=4 (a build chunk, "
          f"{b_launches['dist_topk']} a build): {ms_b:.3f} ms, bound {b_b:.3f} by {by_b}",
          flush=True)
    nq = q_p.shape[0]
    ms = time_ms(lambda: kernels.probe_select(cent_p, q_p, nprobe), 5)
    route_fn = kernels.probe_route
    kernels.probe_route = lambda *a: "sort"
    try:
        sort_ms = time_ms(lambda: kernels.probe_select(cent_p, q_p, nprobe), 5)
    finally:
        kernels.probe_route = route_fn
    plain_ms = time_ms(lambda: kernels.probe_select_plain(cent_p, q_p, nprobe), 3)

    def lib_probe():
        s_ = torch.matmul(q_p, cent_p.T)
        return torch.sort(-2.0 * s_, dim=1, stable=True).indices[:, :nprobe]
    lib_ms = time_ms(lib_probe, 5)
    b_ms, b_by = bound_ms(KNN_NLIST * d * 4 + nq * d * 4 + nq * nprobe * 8,
                          2 * nq * KNN_NLIST * d, "float32")
    rows_t.append({
        "name": "probe_select", "route": "cuda", "source": KNN_SOURCE,
        "replaces": REPLACES["probe_select"], "launches": results[True][0]["probe_select"],
        "max_abs_err": float((kdd - pdd).abs().max()), "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms, "sort_ms": sort_ms,
    })
    print(f"probe_select at {nq} x {KNN_NLIST} x {d} f32, nprobe {nprobe}: fused {ms:.3f} ms, "
          f"keys + sort {sort_ms:.3f} ms; library {lib_ms:.3f} ms; bound {b_ms:.3f} by {b_by}",
          flush=True)
    nl, c_, ml = qv.shape[0], qv.shape[1], rows.shape[1]
    ms = time_ms(lambda: kernels.ivf_scan_select(qv, rows, r2, blk_k), 3)
    plain_ms = time_ms(lambda: kernels.ivf_scan_select_plain(qv, rows, r2, blk_k), 1)

    def lib_scan():
        s_ = torch.bmm(qv, rows.transpose(1, 2))
        return torch.sort(r2[:, None, :] - 2.0 * s_, dim=2, stable=True).indices[..., :blk_k]
    lib_ms = time_ms(lib_scan, 1)
    bk_pad = sel.ceil_to(blk_k, 8)
    b_ms, b_by = bound_ms(qv.numel() * 2 + rows.numel() * 2 + r2.numel() * 4
                          + nl * bk_pad * c_ * 8, 2 * nl * c_ * ml * d, "bfloat16")
    rows_t.append({
        "name": "ivf_scan_select", "route": "cuda", "source": KNN_SOURCE,
        "replaces": REPLACES["ivf_scan_select"],
        "launches": results[True][0]["ivf_scan_select"],
        "max_abs_err": float((flat(sd) - flat(spd)).abs().max()), "ms": ms,
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
    })
    print(f"ivf scan shape: nlist {nl}, C {c_}, maxlen {ml}, blk_k {blk_k}", flush=True)
    # The IVF quantizer's Lloyd step (the phase-17 fit's k = 1,024, d = 768
    # on the bf16 rows): two passes on the tensor-core route.
    xq, cq = x.to(torch.bfloat16), cent.to(torch.bfloat16).contiguous()
    plan = kernels.kmeans_plan(KNN_NLIST, KNN_D, kernels.kmeans_route(xq, cq), KNN_ROWS,
                               torch.cuda.get_device_properties(0).multi_processor_count)
    check_assign(torch, kernels, xq, cq, f"assign_min_dist wgmma {KNN_ROWS} x {KNN_D} "
                 f"k={KNN_NLIST} (the IVF quantizer)")
    ms_l = time_ms(lambda: kernels.lloyd_step(xq, cq, KNN_ROWS), 3)
    ms_a = time_ms(lambda: kernels.assign_min_dist(xq, cq), 3)
    lib_q = time_ms(lambda: torch.matmul(xq, cq.T), 3)
    sum_k, cnt_k = kernels.lloyd_step(xq, cq, KNN_ROWS)
    sum_p, cnt_p = kernels.lloyd_step_plain(xq, cq, KNN_ROWS)
    # The step against the plain version: counts equal as integers (every
    # index above was equal, no near ties), sums against float64 sums of
    # the plain assignment within 1e-5 of each centre's largest column
    # Σ|x| (phase 10's tolerance, per centre: f32 sums of ~1,000 rows in
    # another order).
    check_equal(torch, cnt_k, cnt_p, f"lloyd_step wgmma two-pass {KNN_ROWS} x {KNN_D} "
                                     f"k={KNN_NLIST} counts")
    sums64 = torch.zeros(cq.shape, dtype=torch.float64, device=DEV)
    for r0 in range(0, KNN_ROWS, 1 << 18):
        xv = xq[r0:r0 + (1 << 18)]
        sums64.index_add_(0, kernels.assign_min_dist_plain(xv, cq)[0].long(), xv.double())
    scale_q = center_abs_sums(torch, kernels, xq, cq).amax(dim=1).double().clamp_min(1e-30)
    err_q = float(((sum_k.double() - sums64).abs().amax(dim=1) / scale_q).max())
    err_qp = float(((sum_p.double() - sums64).abs().amax(dim=1) / scale_q).max())
    check(err_q <= 1e-5, f"lloyd_step wgmma two-pass {KNN_ROWS} x {KNN_D} k={KNN_NLIST} sums vs "
                         f"float64: {err_q:.2e} of each centre's largest Σ|x| (tol 1e-5), "
                         f"plain's {err_qp:.2e}")
    del sums64, sum_k, sum_p
    b_q, by_q = bound_ms(KNN_ROWS * KNN_D * 2 + KNN_NLIST * KNN_D * 6 + KNN_NLIST * 8,
                         2 * KNN_ROWS * KNN_NLIST * KNN_D + KNN_ROWS * KNN_D, "bfloat16")
    print(f"ivf quantizer lloyd_step at {KNN_ROWS} x {KNN_D} bf16, k={KNN_NLIST} ({plan}): "
          f"{ms_l:.3f} ms per iteration, assign_min_dist {ms_a:.3f} ms, the product alone "
          f"{lib_q:.3f} ms, bound {b_q:.3f} by {by_q}", flush=True)
    return rows_t


def _dp_feed_task(DataPlaneClient, address, p, rows, abandoned):
    """One Spark partition task of phase 19: its own client, feed_raw
    batches tagged partition/attempt/feed_id, then commit. Partition 0
    first feeds one batch as attempt 0 and abandons it (a retried task);
    partition 1 re-sends its last feed with the same feed_id (a lost ack);
    partition 2 commits twice."""
    with DataPlaneClient(*address, timeout=900.0) as c:
        attempt = 0
        if p == 0:
            c.feed_raw(DP_JOB, abandoned, n_cols=D, partition=0, attempt=0)
            attempt = 1
        for f, x in enumerate(rows):
            if p == 1 and f == len(rows) - 1:
                req = {"op": "feed_raw", "job": DP_JOB, "algo": "pca", "n_cols": D,
                       "partition": p, "attempt": attempt, "feed_id": "phase19-replayed"}
                c._send_arrays_op(dict(req), {"x": x})
                c._send_arrays_op(dict(req), {"x": x})  # the replay: acked, not folded
            else:
                c.feed_raw(DP_JOB, x, n_cols=D, partition=p, attempt=attempt)
        rows_acked = c.commit(DP_JOB, partition=p, attempt=attempt)
        if p == 2:
            rows_acked = c.commit(DP_JOB, partition=p, attempt=attempt)  # duplicate commit
        return rows_acked


def phase_data_plane(torch, kernels, config, scales, mu, fit_pca_stream, PCAModel):
    """Phase 19: the PCA data plane on the card. Returns the gram_colsum
    launches of the wire path and its rows/s."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from spark_rapids_ml_tpu_torch.serve import DataPlaneClient, DataPlaneDaemon
    from spark_rapids_ml_tpu_torch.utils import profiling

    gen = torch.Generator(device=DEV).manual_seed(19)
    n_rows = DP_PARTITIONS * DP_FEEDS * DP_ROWS
    # bf16 rows (the fold's compute dtype) sent as float32, which holds them
    # exactly: the daemon's cast back is exact, so the float64 reference and
    # the in-process fit read the very rows the daemon folds.
    dev_rows = [[make_rows(gen, DP_ROWS, scales, mu, torch.bfloat16) for _ in range(DP_FEEDS)]
                for _ in range(DP_PARTITIONS)]
    host_rows = [[x.float().cpu().numpy() for x in part] for part in dev_rows]
    abandoned = (3.0 * make_rows(gen, DP_ROWS, scales, mu, torch.bfloat16)).float().cpu().numpy()
    wire_gib = (DP_PARTITIONS * DP_FEEDS + 2) * DP_ROWS * D * 4 / 2 ** 30
    print(f"data plane: {DP_PARTITIONS} partition tasks x {DP_FEEDS} feed_raw batches of "
          f"{DP_ROWS} x {D} float32 ({DP_ROWS * D * 4 / 2 ** 20:.0f} MiB a frame): {n_rows} rows; "
          f"with the abandoned attempt and the replayed feed {wire_gib:.2f} GiB on the wire",
          flush=True)

    with DataPlaneDaemon(host="127.0.0.1", port=0, device=DEV) as daemon:
        torch.cuda.synchronize()
        kernels.reset_launches()
        profiling.reset_span_totals()
        # The run is traced (CPU + CUDA activity) for its device time: the
        # device events of every thread, where the trace's CPU ranges are
        # only this thread's (the spans come from span_totals instead).
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            with ThreadPoolExecutor(max_workers=DP_PARTITIONS) as pool:
                futures = [pool.submit(_dp_feed_task, DataPlaneClient, daemon.address, p,
                                       host_rows[p], abandoned)
                           for p in range(DP_PARTITIONS)]
                acked = [f.result() for f in futures]
            t_fed = time.perf_counter() - t0
            with DataPlaneClient(*daemon.address, timeout=900.0) as c:
                status = c.status(DP_JOB)
                out, rows_final = c.finalize(DP_JOB, {"k": K, "mean_center": True}, drop=False)
                dp_s = time.perf_counter() - t0  # first feed to the finalize ack
                c.drop(DP_JOB)
            torch.cuda.synchronize()
        launches = kernels.LAUNCHES["gram_colsum"]
        routes = {k: v for k, v in kernels.ROUTES.items() if k.startswith("gram_colsum/")}
        spans = profiling.span_totals()
        busy_ms, by_name, _ = device_time(torch, prof)
        del prof
        check(status["rows"] == n_rows and rows_final == n_rows and max(acked) == n_rows,
              f"data plane status reads {status['rows']} rows == {n_rows} (retried attempt, "
              f"replayed feed_id and duplicate commit each counted once; finalize {rows_final})")
        folded = DP_PARTITIONS * DP_FEEDS + 1  # every feed, the abandoned one; not the replay
        check(launches == folded,
              f"data plane gram_colsum launches {launches} == folded feeds {folded}")
        check(routes["gram_colsum/wgmma"] == folded and routes["gram_colsum/ffma"] == 0,
              f"every data-plane fold took the tensor-core route: {routes}")

        # The float64 reference of the same (bf16-exact) rows.
        count = torch.tensor(float(n_rows), dtype=torch.float64, device=DEV)
        colsum = torch.zeros(D, dtype=torch.float64, device=DEV)
        gram = torch.zeros((D, D), dtype=torch.float64, device=DEV)
        for part in dev_rows:
            for x in part:
                xd = x.double()
                gram += xd.T @ xd
                colsum += xd.sum(0)
        pc_ref, ev_ref, gap = reference_pca(count, colsum, gram, K)
        del gram, colsum, xd
        err = sign_aligned_err(out["pc"], pc_ref)
        ev_err = float((torch.as_tensor(out["explained_variance"], device=DEV) - ev_ref).abs().max())
        check(out["pc"].shape == (D, K) and bool(np.isfinite(out["pc"]).all()),
              f"data plane pc finite, shape {out['pc'].shape}")
        # Tolerances of phase 3 (the same f32 accumulation over the same
        # bf16 rows; smallest top-32 eigengap printed).
        check(err <= 1e-3, f"data plane pc vs float64 of the same rows: max sign-aligned err "
                           f"{err:.3e} (tol 1e-3; eigengap {gap:.3e})")
        check(ev_err <= 1e-4, f"data plane σ/Σσ vs float64: err {ev_err:.3e} (tol 1e-4)")

        # The in-process stream over the same 16 batches: from the float32
        # host arrays the daemon received (host to device, bf16 on the card),
        # and from the device-resident bf16 rows.
        batches = [x for part in host_rows for x in part]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol = fit_pca_stream(batches, k=K, n_cols=D, device=DEV)
        host_s = time.perf_counter() - t0
        dev_batches = [x for part in dev_rows for x in part]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit_pca_stream(dev_batches, k=K, n_cols=D, device=DEV)
        dev_s = time.perf_counter() - t0
        err_s = sign_aligned_err(out["pc"], torch.as_tensor(sol.pc, device=DEV))
        ev_s = float(np.abs(out["explained_variance"] - sol.explained_variance).max())
        # Tolerance: the same f32 sums of the same rows in another order
        # (per-partition stages added at commit): ~1e-6 of the largest Gram
        # entry, over the 1.6 % eigengap.
        check(err_s <= 1e-3, f"data plane pc vs in-process fit_pca_stream of the same batches: "
                             f"max sign-aligned err {err_s:.3e} (tol 1e-3)")
        check(ev_s <= 1e-5, f"data plane σ/Σσ vs in-process fit_pca_stream: err {ev_s:.3e} "
                            f"(tol 1e-5)")

        # Serving: register the finalized arrays over the wire (raw frames);
        # transform through the daemon's registry in-process.
        model_arrays = {"pc": out["pc"], "explainedVariance": out["explained_variance"],
                        "mean": out["mean"]}
        with DataPlaneClient(*daemon.address) as c:
            created = c.ensure_model("phase19", "pca", model_arrays)
            exists = c.model_exists("phase19")
        check(created and exists, "ensure_model over the wire registered the model; "
                                  "model_status sees it")
        served = daemon._lookup_model("phase19")
        xq = host_rows[0][0]
        y_served = served.transform(xq)["output"]
        y_model = PCAModel(pc=out["pc"], explained_variance=out["explained_variance"],
                           mean=out["mean"], device=DEV).transform_matrix(xq)["output"]
        check(y_served.shape == (DP_ROWS, K) and np.array_equal(y_served, y_model),
              f"registry transform of {DP_ROWS} x {D} bitwise equal to "
              f"PCAModel.transform_matrix of the same arrays")
        print("the Arrow `transform` (and `feed`) ops run only in the CPU tests: this machine "
              "has no pyarrow, and the smoke never imports it", flush=True)
        lat = []
        for _ in range(21):
            t0 = time.perf_counter()
            served.transform(xq)
            lat.append((time.perf_counter() - t0) * 1e3)
        lat.sort()

    # The fold kernel alone at the feed's shape (CUDA events, warm, seeded
    # state as the daemon launches it), outside the run's contention.
    x16 = dev_rows[0][0]
    state = (torch.zeros((D, D), device=DEV), torch.zeros(D, device=DEV),
             torch.zeros((), device=DEV))
    fold_ms = time_ms(lambda: kernels.gram_colsum(x16, DP_ROWS, state), 5)
    fold_dev = [(ms, n) for name, (ms, n) in by_name.items() if "gram_tc_kernel" in name]
    fold_dev_ms = sum(ms for ms, _ in fold_dev)
    fold_dev_n = sum(n for _, n in fold_dev)
    print(f"data plane fit: {n_rows} rows in {dp_s:.3f} s = {n_rows / dp_s:.1f} rows/s "
          f"(first feed to the finalize ack, host clock; feeds and commits done at "
          f"{t_fed:.3f} s), {wire_gib / dp_s:.2f} GiB/s of frames; in-process fit_pca_stream "
          f"of the same rows: {n_rows / host_s:.1f} rows/s from the float32 host arrays, "
          f"{n_rows / dev_s:.1f} rows/s from device-resident bf16", flush=True)
    names = ("daemon frame receive", "daemon frame decode", "daemon host to device",
             "daemon fold", "daemon commit", "eig finalize")
    print("data plane spans (host-clock seconds summed over the connection threads, count): "
          + ", ".join(f"{n} {spans.get(n, (0.0, 0))[0]:.3f} ({spans.get(n, (0.0, 0))[1]})"
                      for n in names)
          + f"; the fold kernel at {DP_ROWS} x {D} bf16 alone (CUDA events) {fold_ms:.3f} ms",
          flush=True)
    parts = ", ".join(f"{name[:48]} {ms:.3f} ({n})"
                      for name, (ms, n) in sorted(by_name.items(), key=lambda r: -r[1][0])[:6])
    print(f"data plane device time (torch.profiler, CUDA activity of every thread): busy "
          f"{busy_ms:.3f} ms of {dp_s * 1e3:.3f} ms ({100 * busy_ms / (dp_s * 1e3):.2f} %, idle "
          f"{100 * (1 - busy_ms / (dp_s * 1e3)):.2f} %); fold kernels {fold_dev_ms:.3f} ms over "
          f"{fold_dev_n} launches; largest (ms, count): {parts}", flush=True)
    print(f"registry transform {DP_ROWS} x {D} float32 host rows -> k={K}: p50 "
          f"{lat[len(lat) // 2]:.3f} ms (host clock, ends on the host array)", flush=True)
    return launches, n_rows / dp_s


def spark_rows(np, p, f, rows, d, k):
    """Partition ``p``'s feed ``f``: numpy rows from the seed (SPARK_SEED, p,
    f), phase 3's spectrum (variances 2 − j/(k−1) for the top k, a 0.1·0.999^j
    tail) and mean, with the low 16 bits of every float32 word cleared, so
    the rows are bf16-exact and the fold's cast loses nothing."""
    j = np.arange(d, dtype=np.float32)
    scales = np.where(j < k, np.sqrt(np.maximum(2.0 - j / (k - 1), 0.0)),
                      0.1 * 0.999 ** j).astype(np.float32)
    mu = (0.05 * np.random.default_rng(SPARK_SEED).standard_normal(d)).astype(np.float32)
    x = np.random.default_rng([SPARK_SEED, p, f]).standard_normal((rows, d), dtype=np.float32)
    x *= scales
    x += mu
    x.view(np.uint32)[...] &= np.uint32(0xFFFF0000)
    return x


def _dying(batches, after):
    """Yield ``after`` batches, then die as a lost executor does: the
    attempt has staged rows and never commits."""
    yield from batches[:after]
    raise RuntimeError("injected executor death mid-partition")


#: What the Spark tasks' fork server imports once (see :func:`task_context`).
_TASK_PRELOAD = ("numpy", "spark_rapids_ml_tpu_torch.serve.client",
                 "spark_rapids_ml_tpu_torch.spark.estimator")
_TASK_SERVER: list = []  # the configured fork-server context, once


def task_context():
    """The multiprocessing context of the Spark task processes: a fork server,
    a fresh interpreter that imports ``_TASK_PRELOAD`` once and never touches
    the card, forks each task, so a pool of 8 starts without 8 interpreters
    each importing torch. A task forked there inherits the server's
    environment, not this process's: a pool whose tasks must read an
    environment variable set later (a fault plan) is spawned instead."""
    import atexit
    import multiprocessing as mp
    import multiprocessing.forkserver as forkserver

    ctx = mp.get_context("forkserver")
    if not _TASK_SERVER:
        ctx.set_forkserver_preload(list(_TASK_PRELOAD))

        def stop():
            # The server exits once this process and every task it forked
            # have let go of it: end the tasks a failed phase left waiting,
            # then wait for the server.
            for child in mp.active_children():
                child.kill()
                child.join(timeout=10)
            forkserver._forkserver._stop()

        atexit.register(stop)
        _TASK_SERVER.append(ctx)
    return ctx


def _spark_task(address, p, rows, d, k, feeds, go, out, trace_ctx=None):
    """Phase 20's partition task, in its own process (forked): builds its
    rows from its seed, signals ready, waits for the start, then runs the
    Spark feed task's body (``estimator._feed_partition``) with a
    ``feed_raw`` sender. Partition SPARK_DYING's attempt 0 dies after one
    feed and its attempt 1 wins; only the winner's ack goes back, as Spark
    returns only a successful task's rows. ``trace_ctx``: the driver's
    journal frame, stamped by the task's client (phase 30), as
    ``estimator._FeedTask`` carries it."""
    try:
        import numpy as np

        from spark_rapids_ml_tpu_torch.serve.client import DataPlaneClient
        from spark_rapids_ml_tpu_torch.spark.estimator import _feed_partition

        batches = [spark_rows(np, p, f, rows, d, k) for f in range(feeds)]
        out.put(("ready", p, None))
        go.wait()
        attempts = [(0, 1), (1, None)] if p == SPARK_DYING else [(0, None)]
        for attempt, dies_after in attempts:
            with DataPlaneClient(*address, timeout=900.0, trace_ctx=trace_ctx) as c:
                def send(x, c=c, attempt=attempt):
                    c.feed_raw(SPARK_JOB, x, n_cols=d, partition=p, attempt=attempt)

                it = batches if dies_after is None else _dying(batches, dies_after)
                try:
                    ack = _feed_partition(c, it, send, SPARK_JOB, p, attempt, None, address)
                except RuntimeError as e:
                    if "injected" not in str(e):
                        raise
                    continue
        out.put(("ok", p, ack))
    except Exception as e:  # noqa: BLE001 - reported to the parent
        out.put(("err", p, repr(e)))


def phase_spark_feed(torch, kernels, fit_pca_stream, dp_rate):
    """Phase 20: the Spark PCA fit's feed protocol from separate processes.
    The port's daemon runs in this process on the card; 8 forked task
    processes run the feed task's body; this process plays the driver with
    the estimator's own functions. Returns (the gram_colsum launches, the
    fit's rows/s)."""
    import multiprocessing as mp

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from spark_rapids_ml_tpu_torch.serve import DataPlaneDaemon
    from spark_rapids_ml_tpu_torch.spark import estimator as est
    from spark_rapids_ml_tpu_torch.utils import profiling

    n_rows = DP_PARTITIONS * DP_FEEDS * DP_ROWS
    print(f"spark feed protocol: {DP_PARTITIONS} task processes (forked) x {DP_FEEDS} feed_raw "
          f"batches of {DP_ROWS} x {D} float32 (bf16-exact numpy rows from each task's seed): "
          f"{n_rows} rows; partition {SPARK_DYING}'s attempt 0 dies after one feed", flush=True)
    ctx = task_context()  # never fork a process that holds a CUDA context
    out, go = ctx.Queue(), ctx.Event()
    procs = []
    with DataPlaneDaemon(host="127.0.0.1", port=0, device=DEV) as daemon:
        try:
            t_spawn = time.perf_counter()
            procs = [ctx.Process(target=_spark_task,
                                 args=(daemon.address, p, DP_ROWS, D, K, DP_FEEDS, go, out),
                                 daemon=True)
                     for p in range(DP_PARTITIONS)]
            for proc in procs:
                proc.start()
            for _ in procs:
                msg = out.get(timeout=300)
                if msg[0] != "ready":
                    fail(f"spark task {msg[1]} failed before it was ready: {msg[2]}")
            print(f"spark tasks ready (forked, imported the port, built their rows) in "
                  f"{time.perf_counter() - t_spawn:.1f} s", flush=True)
            host, port = daemon.address
            fit = est._DaemonFit(host, port, SPARK_JOB)
            torch.cuda.synchronize()
            kernels.reset_launches()
            profiling.reset_span_totals()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                go.set()
                results = [out.get(timeout=600) for _ in procs]
                t_fed = time.perf_counter() - t0
                bad = [r for r in results if r[0] != "ok"]
                check(not bad, f"spark tasks all succeeded: {bad}")
                acks = [r[2] for r in results]
                n, per, _, owner, boots = est._ack_rows(acks)
                check(fit.account(acks) == n, "the driver's row accounting took the acks")
                status = fit.client.status(SPARK_JOB)["rows"]
                arrays, fin_rows = fit.finalize_guarded({"k": K, "mean_center": True},
                                                        pass_rows_expected=n)
                sp_s = time.perf_counter() - t0  # the go signal to the finalize ack
                fit.close()
                torch.cuda.synchronize()
        finally:
            for proc in procs:  # a task still waiting for the start is stopped at once
                proc.join(timeout=30 if go.is_set() else 0)
                if proc.is_alive():
                    proc.terminate()
                    proc.join(timeout=10)
    model = est._pca_model(arrays, device=DEV)
    launches = kernels.LAUNCHES["gram_colsum"]
    routes = {k: v for k, v in kernels.ROUTES.items() if k.startswith("gram_colsum/")}
    spans = profiling.span_totals()
    busy_ms, by_name, _ = device_time(torch, prof)
    del prof
    check(n == status == fin_rows == n_rows and sorted(owner) == list(range(DP_PARTITIONS))
          and all(len(b) == 1 for b in boots.values()) and len(per) == 1,
          f"spark feed: acked {n}, status {status}, finalize {fin_rows} rows == {n_rows}, one "
          f"daemon and one incarnation, every partition owned")
    folded = DP_PARTITIONS * DP_FEEDS + 1  # every feed and the dead attempt's one
    check(launches == folded, f"spark feed gram_colsum launches {launches} == folded feeds {folded}")
    check(routes["gram_colsum/wgmma"] == folded and routes["gram_colsum/ffma"] == 0,
          f"every spark-feed fold took the tensor-core route: {routes}")
    check(model.pc.shape == (D, K) and bool(np.isfinite(model.pc).all()),
          f"spark PCAModel pc finite, shape {model.pc.shape}")

    # References from the same rows, rebuilt here from the tasks' seeds: a
    # float64 Gram on the card, and the in-process stream of the batches.
    count = torch.tensor(float(n_rows), dtype=torch.float64, device=DEV)
    colsum = torch.zeros(D, dtype=torch.float64, device=DEV)
    gram = torch.zeros((D, D), dtype=torch.float64, device=DEV)
    from concurrent.futures import ThreadPoolExecutor

    def batches():
        keys = [(p, f) for p in range(DP_PARTITIONS) for f in range(DP_FEEDS)]
        with ThreadPoolExecutor(max_workers=8) as pool:
            for x in pool.map(lambda pf: spark_rows(np, pf[0], pf[1], DP_ROWS, D, K), keys):
                xd = torch.from_numpy(x).to(DEV).double()
                gram.addmm_(xd.T, xd)
                colsum.add_(xd.sum(0))
                del xd
                yield x

    sol = fit_pca_stream(batches(), k=K, n_cols=D, device=DEV)
    pc_ref, ev_ref, gap = reference_pca(count, colsum, gram, K)
    del gram, colsum
    err = sign_aligned_err(model.pc, pc_ref)
    ev_err = float((torch.as_tensor(model.explainedVariance, device=DEV) - ev_ref).abs().max())
    check(err <= 1e-3, f"spark pc vs float64 of the same rows: max sign-aligned err {err:.3e} "
                       f"(tol 1e-3; eigengap {gap:.3e})")
    check(ev_err <= 1e-4, f"spark σ/Σσ vs float64: err {ev_err:.3e} (tol 1e-4)")
    err_s = sign_aligned_err(model.pc, torch.as_tensor(sol.pc, device=DEV))
    ev_s = float(np.abs(model.explainedVariance - sol.explained_variance).max())
    # Tolerance: the same f32 sums of the same rows in another order (the
    # stages added at commit); phase 19 measured 3.6e-6 on its components.
    check(err_s <= 1e-5 and ev_s <= 1e-5,
          f"spark pc vs in-process fit_pca_stream of the same rows: max sign-aligned err "
          f"{err_s:.3e}, σ/Σσ {ev_s:.3e} (tol 1e-5 each)")

    wire_gib = (n_rows + DP_ROWS) * D * 4 / 2 ** 30
    names = ("daemon frame receive", "daemon frame decode", "daemon host to device",
             "daemon fold", "daemon commit", "finalize", "eig finalize")
    fold_dev = [(ms, c) for name, (ms, c) in by_name.items() if "gram_tc_kernel" in name]
    print(f"spark feed fit: {n_rows} rows in {sp_s:.3f} s = {n_rows / sp_s:.1f} rows/s (the go "
          f"signal to the finalize ack, host clock; acks in at {t_fed:.3f} s), "
          f"{wire_gib / sp_s:.2f} GiB/s of frames; phase 19 (threads in the daemon's process) "
          f"{dp_rate:.1f} rows/s in this run", flush=True)
    print("spark feed spans (host-clock seconds summed over the daemon's connection threads, "
          "count): " + ", ".join(f"{nm} {spans.get(nm, (0.0, 0))[0]:.3f} "
                                 f"({spans.get(nm, (0.0, 0))[1]})" for nm in names), flush=True)
    print(f"spark feed device time (torch.profiler, CUDA activity): busy {busy_ms:.3f} ms of "
          f"{sp_s * 1e3:.3f} ms ({100 * busy_ms / (sp_s * 1e3):.2f} %, idle "
          f"{100 * (1 - busy_ms / (sp_s * 1e3)):.2f} %); fold kernels "
          f"{sum(ms for ms, _ in fold_dev):.3f} ms over {sum(c for _, c in fold_dev)} launches",
          flush=True)
    ONE_DAEMON_RATES["phase 20 pca"] = n_rows / sp_s
    return launches, n_rows / sp_s


#: Phase 21: run → (wire algo, width, rows a frame, frames a partition per
#: pass, classes or k). The task processes get it as an argument.
P21_RUNS = {
    "linreg": ("linreg", LR_D, DP_ROWS, 2, 0),
    "logreg-multinomial": ("logreg", LG_D, 16384, 1, MN_CLASSES),
    "logreg-binomial": ("logreg", LG_D, DP_ROWS, 1, 2),
    "kmeans": ("kmeans", KM_D, DP_ROWS, 2, KM_K),
}
P21_SEED = 21
P21_PASSES = MN_PASSES  # both logreg runs: five passes at tol 0, as phase 12
KM21_NOISE = KM_SCALE / 100  # blob noise: squared separations 1e4 times the spread
#: Phase 22: the knn job's frames (run → the P21_RUNS fields; the last is
#: the mixture's component count), from the seed (P22_SEED, partition, frame).
P22_RUNS = {"knn": ("knn", KNN_D, DP_ROWS, DP_FEEDS, KNN_CLUSTERS)}
P22_SEED = 22


def rf_part_rows(total, p):
    """Rows of partition ``p`` of a ``total``-row dataset split over
    DP_PARTITIONS as evenly as rows allow (the first ones one longer)."""
    return total // DP_PARTITIONS + int(p < total % DP_PARTITIONS)


#: Phase 25: the forests' frames (run → the P21_RUNS fields: algo, width,
#: rows a frame, frames a partition (the last one short), classes; then
#: the dataset's rows). The task processes get it as an argument.
P25_RUNS = {kind: ("rf", d, DP_ROWS, -(-rf_part_rows(n, 0) // DP_ROWS), c, n)
            for kind, d, c, n in (("higgs", HIGGS_D, 2, HIGGS_ROWS), ("msd", MSD_D, 0, MSD_ROWS))}
P25_TRACED_PASS = 3  # the scan traced for the device busy share (depth 2 → 3)
P25_DIRECT_FRAMES = 16  # partition 0's first 1,048,576 rows, fed partition-less


def rf_frame(np, runs, kind, p, f, rows=None):
    """Phase 25's partition ``p`` frame ``f`` of ``runs[kind]`` (``rows``
    rows, else the frame's share of the partition): ``rf_rows``'s model in
    numpy, drawn from the seed (RF_SEED, kind, p, f), float32 features and
    float64 labels (HIGGS's 0/1 classes, MSD's integer years)."""
    _, d, frame_rows, _, _, total = runs[kind]
    n = rows if rows is not None else min(frame_rows, rf_part_rows(total, p) - f * frame_rows)
    g = np.random.default_rng([RF_SEED, 0 if kind == "higgs" else 1, p, f])
    if kind == "higgs":
        x = g.standard_normal((n, d), dtype=np.float32)
        x[:, 21:28] = np.sqrt(x[:, 0:7] ** 2 + x[:, 7:14] ** 2) + np.float32(0.3) * x[:, 21:28]
        logit = (1.2 * (x[:, 21] - 1.25) - 0.8 * (x[:, 22] - 1.25) + 0.6 * x[:, 3] * x[:, 4]
                 + 0.4 * x[:, 5] - 0.3 * x[:, 24])
        y = g.random(n) < 1.0 / (1.0 + np.exp(-logit.astype(np.float64)))
        return x, y.astype(np.float64)
    scales = np.ones(d, np.float32)
    scales[:12] = np.linspace(5.0, 40.0, 12, dtype=np.float32)
    x = g.standard_normal((n, d), dtype=np.float32) * scales
    s = x[:, :12] / scales[:12]
    z = np.tanh(0.5 * s[:, 0] - 0.4 * s[:, 1] + 0.3 * s[:, 2] * s[:, 3]) + 0.2 * x[:, 12]
    year = 1998.0 + 9.0 * z.astype(np.float64) + 3.0 * g.standard_normal(n)
    return x, np.clip(np.round(year), 1922.0, 2011.0)


def rf_bag_sums(np, frames, p, n_trees, seed, n_classes):
    """The root statistics partition ``p``'s rows give every tree: float64
    sums of the Poisson(1) bag weights of ``row_identity_keys(p, offset)``,
    per class (``n_classes`` > 0) or in all (a regressor's count), from the
    port's ``bootstrap_weights`` on this machine's CPU. (T, max(C, 1))."""
    import torch

    from spark_rapids_ml_tpu_torch.models.random_forest import row_identity_keys
    from spark_rapids_ml_tpu_torch.ops.histogram import bootstrap_weights

    torch.set_num_threads(1)
    out = np.zeros((n_trees, max(n_classes, 1)))
    offset = 0
    for _, y in frames:
        n = y.shape[0]
        keys = torch.from_numpy(row_identity_keys(p, offset, n).astype(np.int64))
        w = bootstrap_weights(keys, n_trees, seed).double().numpy()
        if n_classes:
            for c in range(n_classes):
                out[:, c] += w[:, y == c].sum(1)
        else:
            out[:, 0] += w.sum(1)
        offset += n
    return out


def knn_frame(np, p, f, rows, d, clusters):
    """Phase 22's partition ``p`` frame ``f`` (``p`` = DP_PARTITIONS: the
    queries): bench_knn.py's mixture as ``knn_data`` draws it, a centre
    drawn uniformly plus KNN_SPREAD · N(0, 1) per coordinate, in numpy
    float32 from the seed (P22_SEED, p, f); the ``clusters`` N(0, 1)
    centres from (P22_SEED,)."""
    centres = np.random.default_rng(P22_SEED).standard_normal((clusters, d), dtype=np.float32)
    g = np.random.default_rng([P22_SEED, p, f])
    x = centres[g.integers(0, clusters, rows)]
    x += np.float32(KNN_SPREAD) * g.standard_normal((rows, d), dtype=np.float32)
    return x


def p21_frame(np, runs, run, p, f):
    """Partition ``p``'s frame ``f`` of phase 21's ``run`` (shaped by
    ``runs[run]``), from the seed
    (P21_SEED, run, p, f): bf16-exact float32 rows (the low 16 bits of
    every word cleared, so the daemon's bf16 cast loses nothing) and their
    labels (None for kmeans). The model the labels come from is shared by
    every partition, from the seed (P21_SEED, run): linear targets with
    noise 0.1; Bernoulli labels of sigmoid(x·w + 0.3); multinomial labels
    drawn from softmax(xW + b) over the classes; kmeans rows are k blobs of
    centres KM_SCALE·N(0, 1) with noise KM21_NOISE."""
    if run in ("higgs", "msd"):  # phase 25
        return rf_frame(np, runs, run, p, f)
    _, d, rows, _, k = runs[run]
    if run == "knn":
        return knn_frame(np, p, f, rows, d, k), None
    if run in ("scaler", "pca"):  # phases 23 and 27: phase 20's rows
        return spark_rows(np, p, f, rows, d, k), None
    if run == "kmeans-int":  # phase 28: integer blobs, every sum an exact f32 sum
        centres = np.random.default_rng([P28_SEED, d]).integers(-12, 13, (k, d)) * 4
        g = np.random.default_rng([P28_SEED, d, p, f])
        x = (centres[g.integers(0, k, rows)] + g.integers(-1, 2, (rows, d))).astype(np.float32)
        return x, None
    if run.endswith("-int"):  # phase 27: rows in {-1, 0, 1}, every statistic an exact f32 sum
        g = np.random.default_rng([P27_SEED, d, p, f])
        x = g.integers(-1, 2, (rows, d), dtype=np.int8).astype(np.float32)
        return x, (None if runs[run][0] == "pca" else np.sign(x[:, :8].sum(1)))
    r = list(runs).index(run)
    g = np.random.default_rng([P21_SEED, r, p, f])
    shared = np.random.default_rng([P21_SEED, r])
    if run == "kmeans":
        centres = (KM_SCALE * shared.standard_normal((k, d))).astype(np.float32)
        x = centres[g.integers(0, k, rows)]
        x += np.float32(KM21_NOISE) * g.standard_normal((rows, d), dtype=np.float32)
    else:
        x = g.standard_normal((rows, d), dtype=np.float32)
    x.view(np.uint32)[...] &= np.uint32(0xFFFF0000)
    if run == "kmeans":
        return x, None
    if run == "logreg-multinomial":
        z = x @ (shared.standard_normal((d, k)) / d ** 0.5)
        z += 0.5 * shared.standard_normal(k)
        z = np.exp(z - z.max(axis=1, keepdims=True))
        cdf = np.cumsum(z / z.sum(axis=1, keepdims=True), axis=1)
        y = np.minimum((cdf < g.random(rows)[:, None]).sum(axis=1), k - 1)
        return x, y.astype(np.float32)
    z = x @ (shared.standard_normal(d) / d ** 0.5)
    if run == "linreg":
        return x, (z + 0.5 + 0.1 * g.standard_normal(rows)).astype(np.float32)
    return x, (g.random(rows) < 1.0 / (1.0 + np.exp(-(z + 0.3)))).astype(np.float32)


def _p21_task(address, p, runs, cmd_q, out_q):
    """Phase 21's partition task ``p``: one forked process serving every
    pass of every run. ("prepare", run) builds the partition's frames from
    its seed; ("bags", run, trees, seed, classes) answers ``rf_bag_sums``
    of them; (run, job, params, pass_id, dies) runs the Spark feed task's
    body (``estimator._feed_partition``) with a ``feed_raw`` sender of
    (x, y) frames. With ``dies``, attempt 0 dies after one feed and
    attempt 1 wins; only the winner's ack goes back, as Spark returns only
    a successful task's rows. ``to``: the partition's daemon (phase 27), or
    a list of them, one an attempt (phase 28: a task whose daemon refuses
    or is gone fails, and Spark runs its next attempt on the next host).
    The ack carries the winning client's healing counters (``stats``)."""
    try:
        import numpy as np

        from spark_rapids_ml_tpu_torch.serve.client import DataPlaneClient
        from spark_rapids_ml_tpu_torch.spark.estimator import _feed_partition
    except Exception as e:  # noqa: BLE001 - reported to the parent
        out_q.put(("err", p, repr(e)))
        return
    out_q.put(("ready", p, None))
    frames = {}
    while True:
        cmd = cmd_q.get()
        if cmd is None:
            return
        try:
            if cmd[0] == "prepare":
                frames = {cmd[1]: [p21_frame(np, runs, cmd[1], p, f)
                                   for f in range(runs[cmd[1]][3])]}
                out_q.put(("ready", p, None))
                continue
            if cmd[0] == "bags":
                out_q.put(("ok", p, rf_bag_sums(np, frames[cmd[1]], p, *cmd[2:])))
                continue
            run, job, params, pass_id, dies, to = cmd
            if to is None:
                addrs = [address]
            elif isinstance(to[0], (list, tuple)):
                addrs = [tuple(a) for a in to]
            else:
                addrs = [tuple(to)]
            failover = len(addrs) > 1
            plan = ([(i, None) for i in range(len(addrs))] if failover
                    else [(0, 1), (1, None)] if dies else [(0, None)])
            algo, d = runs[run][:2]
            for i, (attempt, dies_after) in enumerate(plan):
                addr = addrs[min(i, len(addrs) - 1)]
                kw = {"max_op_attempts": 2} if failover else {}
                with DataPlaneClient(*addr, timeout=900.0, **kw) as c:
                    def send(b, c=c, attempt=attempt):
                        c.feed_raw(job, b[0], b[1], algo=algo, n_cols=d, params=params,
                                   partition=p, attempt=attempt, pass_id=pass_id)

                    batches = frames[run]
                    it = batches if dies_after is None else _dying(batches, dies_after)
                    try:
                        ack = _feed_partition(c, it, send, job, p, attempt, pass_id, addr)
                    except (RuntimeError, OSError) as e:
                        if failover and i < len(plan) - 1:
                            continue  # the next attempt, on the next host
                        if "injected" not in str(e):
                            raise
                        continue
                    ack["stats"] = dict(c.stats)
                    break
            out_q.put(("ok", p, ack))
        except Exception as e:  # noqa: BLE001 - reported to the parent
            out_q.put(("err", p, repr(e)))


class _P21Pool:
    """The 8 task processes of phase 21 (or 22, 23 and 25, with their
    ``runs``), started once from ``ctx`` (default :func:`task_context`;
    never fork a process that holds a CUDA context) and reused by every
    pass of every run, so their start and imports stay out of the timed
    passes."""

    def __init__(self, address, runs=None, wait=True, ctx=None):
        ctx = ctx or task_context()
        self.out = ctx.Queue()
        self.cmds = [ctx.Queue() for _ in range(DP_PARTITIONS)]
        self.procs = [ctx.Process(target=_p21_task,
                                  args=(address, p, P21_RUNS if runs is None else runs,
                                        self.cmds[p], self.out),
                                  daemon=True) for p in range(DP_PARTITIONS)]
        for proc in self.procs:
            proc.start()
        if wait:
            self.ready()

    def ready(self):
        """Wait until every task process has imported the port."""
        self._collect("ready", 300)

    def _collect(self, want, timeout):
        msgs = [self.out.get(timeout=timeout) for _ in self.procs]
        bad = [m for m in msgs if m[0] != want]
        if bad:
            fail(f"task processes failed: {bad}")
        return [m[2] for m in sorted(msgs, key=lambda m: m[1])]

    def prepare(self, run):
        for q in self.cmds:
            q.put(("prepare", run))
        self._collect("ready", 300)

    def bags(self, run, n_trees, seed, n_classes):
        """Every partition's ``rf_bag_sums`` of the prepared ``run``."""
        for q in self.cmds:
            q.put(("bags", run, n_trees, seed, n_classes))
        return self._collect("ok", 600)

    def scan(self, run, job, params, pass_id, dies, route=None):
        """One pass: every partition task feeds and commits; their acks.
        With ``dies``, partition SPARK_DYING's first attempt dies. ``route``
        ({partition: address, or a list of addresses, one an attempt})
        sends a partition to another daemon than the pool's (an executor on
        another host)."""
        for p, q in enumerate(self.cmds):
            q.put((run, job, params, pass_id, dies and p == SPARK_DYING,
                   (route or {}).get(p)))
        return self._collect("ok", 600)

    def close(self):
        for q in self.cmds:
            q.put(None)
        for proc in self.procs:
            proc.join(timeout=30)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=10)


def p21_fit(torch, kernels, est, profiling, pool, address, run, drive, runs=None,
            tag="phase 21"):
    """One phase-21 fit (or phase 23's, with its ``runs`` and ``tag``): the
    estimator's driver function ``drive(fit, run_pass)`` over the pool's
    passes, with the counters reset just before it and read just after,
    traced for its device time. Returns (model, a record of the run)."""
    from torch.profiler import ProfilerActivity, profile

    runs = P21_RUNS if runs is None else runs
    pool.prepare(run)
    job = f"{tag.replace(' ', '')}-{run}"
    fit = est._DaemonFit(*address, job)
    rec = {"scans": 0}
    real = fit.finalize_guarded

    def guarded(params, pass_rows_expected=None):
        rec["status"] = fit.client.status(job)["rows"]
        arrays, rows = real(params, pass_rows_expected)
        rec["finalize"] = rows
        return arrays, rows

    fit.finalize_guarded = guarded

    def run_pass(pass_id):
        rec["scans"] += 1
        return pool.scan(run, job, fit.params, pass_id, dies=rec["scans"] == 1)

    torch.cuda.synchronize()
    kernels.reset_launches()
    profiling.reset_span_totals()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model = drive(fit, run_pass)
        rec["s"] = time.perf_counter() - t0
        torch.cuda.synchronize()
    fit.close()
    rec["launches"], rec["routes"] = dict(kernels.LAUNCHES), dict(kernels.ROUTES)
    rec["acked"] = fit.total_fed
    rec["spans"] = profiling.span_totals()
    rec["busy_ms"], by_name, _ = device_time(torch, prof)
    del prof
    _, d, rows, frames, _ = runs[run]
    n = DP_PARTITIONS * frames * rows
    rec["rows"] = n
    ONE_DAEMON_RATES[f"{tag} {run}"] = n * rec["scans"] / rec["s"]
    check(rec["acked"] == rec["status"] == rec["finalize"] == n * rec["scans"],
          f"{tag} {run}: acked {rec['acked']}, status {rec['status']}, finalize "
          f"{rec['finalize']} rows == {rec['scans']} scans x {n} (the dying attempt's rows "
          f"counted nowhere)")
    frame_gib = rec["scans"] * n * (d + 1) * 4 / 2 ** 30
    names = ("daemon frame receive", "daemon frame decode", "daemon host to device",
             "daemon fold", "daemon commit", "daemon seed", "daemon step", "feed pass", "seed",
             "step", "finalize")
    spans = rec["spans"]
    print(f"{tag} {run}: {n} rows x {d}, {rec['scans']} scans in {rec['s']:.3f} s: "
          f"{n * rec['scans'] / rec['s']:.1f} rows/s through the daemon "
          f"({n / rec['s']:.1f} rows/s of the dataset), {1e3 * rec['s'] / rec['scans']:.1f} ms "
          f"per pass (scan and step), {frame_gib / rec['s']:.2f} GiB/s of frames (host clock)",
          flush=True)
    print(f"{tag} {run} spans (host-clock seconds summed over threads, count): "
          + ", ".join(f"{nm} {spans.get(nm, (0.0, 0))[0]:.3f} ({spans.get(nm, (0.0, 0))[1]})"
                      for nm in names if nm in spans), flush=True)
    top = ", ".join(f"{nm[:40]} {ms:.3f} ({c})"
                    for nm, (ms, c) in sorted(by_name.items(), key=lambda r: -r[1][0])[:4])
    print(f"{tag} {run} device time (torch.profiler, CUDA activity): busy "
          f"{rec['busy_ms']:.3f} ms of {rec['s'] * 1e3:.3f} ms "
          f"({100 * rec['busy_ms'] / (rec['s'] * 1e3):.2f} %); largest (ms, count): {top}",
          flush=True)
    return model, rec


def p21_served(daemon, model, algo, xq, run) -> None:
    """Register the fitted model over the wire and hold the registry's
    transform bitwise to ``transform_matrix`` on the same host rows."""
    import numpy as np

    from spark_rapids_ml_tpu_torch.serve import DataPlaneClient

    name = f"phase21-{run}"
    with DataPlaneClient(*daemon.address) as c:
        created = c.ensure_model(name, algo, model._model_data())
    got = daemon._lookup_model(name).transform(xq)
    want = model.transform_matrix(xq)
    same = sorted(got) == sorted(want) and all(
        got[r].dtype == want[r].dtype and np.array_equal(got[r], want[r]) for r in want)
    check(created and same, f"phase 21 {run}: served predict of {xq.shape[0]} x {xq.shape[1]} "
                            f"through ensure_model bitwise equal to transform_matrix "
                            f"({', '.join(sorted(want))})")


def p21_device_frames(torch, np, run):
    """Every frame of ``run`` rebuilt from the tasks' seeds, on the card,
    partition-major: [(x, y or None)]."""
    from concurrent.futures import ThreadPoolExecutor

    frames = P21_RUNS[run][3]
    keys = [(p, f) for p in range(DP_PARTITIONS) for f in range(frames)]
    with ThreadPoolExecutor(max_workers=8) as pool:
        host = list(pool.map(lambda pf: p21_frame(np, P21_RUNS, run, pf[0], pf[1]), keys))
    return [(torch.from_numpy(x).to(DEV), None if y is None else torch.from_numpy(y).to(DEV))
            for x, y in host]


def phase_iterative_jobs(torch, kernels, config):
    """Phase 21: the Spark feed protocol of LinearRegression,
    LogisticRegression (multinomial and binomial) and KMeans through the
    port's daemon on the card. Returns {kernel: launches} of the path."""
    import numpy as np

    from spark_rapids_ml_tpu_torch import KMeans, LinearRegression, LogisticRegression
    from spark_rapids_ml_tpu_torch.models import kmeans as km
    from spark_rapids_ml_tpu_torch.models import linear_regression as lr
    from spark_rapids_ml_tpu_torch.models import logistic_regression as lg
    from spark_rapids_ml_tpu_torch.serve import DataPlaneDaemon
    from spark_rapids_ml_tpu_torch.spark import estimator as est
    from spark_rapids_ml_tpu_torch.utils import profiling

    print(f"phase 21: the iterative daemon jobs, {DP_PARTITIONS} task processes (forked, reused "
          f"across passes) x feed_raw frames of (x, y) float32 (bf16-exact rows from each "
          f"task's seed); partition {SPARK_DYING}'s attempt 0 dies after one feed in each "
          f"fit's first scan", flush=True)
    out = {}
    with DataPlaneDaemon(host="127.0.0.1", port=0, device=DEV) as daemon:
        t_spawn = time.perf_counter()
        pool = _P21Pool(daemon.address)
        print(f"phase 21 tasks ready (forked, imported the port) in "
              f"{time.perf_counter() - t_spawn:.1f} s", flush=True)
        try:
            # -- LinearRegression: one scan, linreg_stats per folded feed -----
            core = LinearRegression(device=DEV)
            model, rec = p21_fit(torch, kernels, est, profiling, pool, daemon.address, "linreg",
                                 lambda fit, rp: est._drive_linreg(fit, rp, core))
            folded = 2 * DP_PARTITIONS + 1  # every frame and the dying attempt's one
            launches = rec["launches"]["linreg_stats"]
            check(launches == folded and rec["routes"]["linreg_stats/wgmma"] == folded
                  and sum(rec["launches"].values()) == folded,
                  f"phase 21 linreg: linreg_stats launches {launches} == folded feeds {folded}, "
                  f"all wgmma, no other kernel")
            out["linreg_stats"] = launches
            parts = p21_device_frames(torch, np, "linreg")
            st = lr.init_normal_eq_stats(LR_D, device=DEV)
            for x, y in parts:
                lr.streaming_normal_eq_update(st, x, y)
            sol = lr.finalize_normal_eq_stats(st, 0.0, 0.0, True, 500, 1e-6, rec["rows"])
            ref = lr_reference(torch, parts, lr)
            err = float(abs(model.coefficients - sol.coefficients).max())
            err64 = float(abs(model.coefficients - ref.coefficients).max())
            # Tolerance: the same float32 statistics of the same bf16 rows in
            # another order (stages added at commit) move a well-conditioned
            # solution by about 1e-6; phase 9's 1e-4 against float64.
            check(err <= 1e-4 and abs(model.intercept - sol.intercept) <= 1e-4 and err64 <= 1e-4,
                  f"phase 21 linreg vs the in-process streaming_normal_eq_update fit of the same "
                  f"frames: coefficients max err {err:.3e} (tol 1e-4); vs float64 {err64:.3e} "
                  f"(tol 1e-4); rmse {model.summary.rmse:.6f}")
            xq = parts[0][0].cpu().numpy()
            del parts, st
            p21_served(daemon, model, "linreg", xq, "linreg")

            # -- LogisticRegression, multinomial: softmax_curvature per feed ----
            core = (LogisticRegression(device=DEV).setRegParam(LG_REG).setMaxIter(P21_PASSES)
                    .setTol(0.0))
            model, rec = p21_fit(torch, kernels, est, profiling, pool, daemon.address,
                                 "logreg-multinomial",
                                 lambda fit, rp: est._drive_logreg(fit, rp, core, MN_CLASSES))
            folded = DP_PARTITIONS * rec["scans"] + 1
            launches = rec["launches"]["softmax_curvature"]
            check(rec["scans"] == P21_PASSES and launches == folded
                  and rec["routes"]["softmax_curvature/wgmma"] == folded
                  and sum(rec["launches"].values()) == folded,
                  f"phase 21 multinomial: {rec['scans']} passes; softmax_curvature launches "
                  f"{launches} == folded feeds {folded}, all wgmma, no other kernel")
            out["softmax_curvature"] = launches
            hist = model.summary.objectiveHistory
            check(all(b <= a * (1 + 1e-6) for a, b in zip(hist, hist[1:])),
                  "phase 21 multinomial objective does not increase from pass to pass (MM "
                  "descent, 1e-6 rel): " + ", ".join(f"{v:.8f}" for v in hist))
            parts = p21_device_frames(torch, np, "logreg-multinomial")
            sol = lg.fit_multinomial_stream(lambda: iter(parts), LG_D, MN_CLASSES, reg=LG_REG,
                                            max_iter=P21_PASSES, tol=0.0, device=DEV)
            scale = float(np.abs(sol.coefficients).max())
            err_w = float(np.abs(model.coefficients - sol.coefficients).max()) / scale
            err_b = float(np.abs(model.intercept - sol.intercept).max()) / scale
            # Tolerance: phase 12's against float64 (3e-5 and 1e-3 of max|W|):
            # the same f32 statistics summed in another order through five
            # MM steps.
            check(err_w <= 3e-5 and err_b <= 1e-3,
                  f"phase 21 multinomial vs the in-process fit_multinomial_stream of the same "
                  f"frames: max err W {err_w:.3e} (tol 3e-5), b {err_b:.3e} (tol 1e-3) of "
                  f"max|W| {scale:.4f}")
            xq = parts[0][0].cpu().numpy()
            del parts
            p21_served(daemon, model, "logreg", xq, "logreg-multinomial")

            # -- LogisticRegression, binomial: no kernel (plain products) -------
            core = (LogisticRegression(device=DEV).setRegParam(LG_REG).setMaxIter(P21_PASSES)
                    .setTol(0.0))
            model, rec = p21_fit(torch, kernels, est, profiling, pool, daemon.address,
                                 "logreg-binomial",
                                 lambda fit, rp: est._drive_logreg(fit, rp, core, 2))
            check(rec["scans"] == P21_PASSES and sum(rec["launches"].values()) == 0,
                  f"phase 21 binomial: {rec['scans']} passes, no kernel launched (the reference's "
                  f"stream update uses none): {rec['launches']}")
            parts = p21_device_frames(torch, np, "logreg-binomial")
            sol = lg.fit_logistic_stream(lambda: iter(parts), LG_D, reg=LG_REG,
                                         max_iter=P21_PASSES, tol=0.0, device=DEV)
            wn = float(np.linalg.norm(sol.coefficients))
            err_w = float(np.linalg.norm(model.coefficients - sol.coefficients)) / wn
            err_b = abs(float(model.intercept) - float(sol.intercept)) / wn
            # Tolerance: phase 11's against float64 (1e-5 of ‖w‖): the same f32
            # products summed in another order through five Newton steps.
            check(err_w <= 1e-5 and err_b <= 1e-5,
                  f"phase 21 binomial vs the in-process fit_logistic_stream of the same frames: "
                  f"‖Δw‖/‖w‖ {err_w:.3e}, |Δb|/‖w‖ {err_b:.3e} (tol 1e-5; ‖w‖ {wn:.4f})")
            xq = parts[0][0].cpu().numpy()
            del parts
            p21_served(daemon, model, "logreg", xq, "logreg-binomial")

            # -- KMeans: seed, Lloyd passes, the cost scan; no kernel ------------
            seed_rows = est._kmeans_seed_rows(KM_K)
            sample = p21_frame(np, P21_RUNS, "kmeans", 0, 0)[0][:seed_rows]  # sel.limit's prefix
            core = (KMeans(device=DEV).setK(KM_K).setMaxIter(KM_MAX_ITER).setTol(KM_TOL)
                    .setSeed(P21_SEED))
            model, rec = p21_fit(torch, kernels, est, profiling, pool, daemon.address, "kmeans",
                                 lambda fit, rp: est._drive_kmeans(fit, rp, core, sample))
            print(f"phase 21 kmeans kernel counters (held at 0: the reference's daemon folds "
                  f"kmeans without its kernel): {rec['launches']}", flush=True)
            check(sum(rec["launches"].values()) == 0 and rec["scans"] == model.summary.numIter + 1,
                  f"phase 21 kmeans: {model.summary.numIter} Lloyd passes and the cost scan, no "
                  f"kernel launched")
            parts = p21_device_frames(torch, np, "kmeans")
            xk = torch.cat([x for x, _ in parts])
            del parts
            cd = config.compute_dtype(DEV)
            # The float64 Lloyd from the same seeded centres (the daemon's host
            # k-means++ of the same sample and generator), each pass scored at
            # the centres rounded to the compute dtype, as the fold scores.
            c = km._kmeans_plus_plus(sample, KM_K, np.random.default_rng(P21_SEED))
            c = torch.as_tensor(c, device=DEV).float().double()  # the job holds them in f32
            ref_iter = 0
            for ref_iter in range(1, KM_MAX_ITER + 1):
                means, counts, _ = lloyd_reference(torch, xk, c.cpu().numpy(), cd)
                new = torch.where((counts > 0)[:, None], means, c)
                moved2 = float(((new - c) ** 2).sum(1).max())
                c = new
                if moved2 <= KM_TOL ** 2:
                    break
            err_c = float((torch.as_tensor(model.centers, device=DEV).double() - c).abs().max())
            # Tolerance: float32 sums of the same bf16 rows in another order
            # move a blob's mean by about 1e-9; 1e-6 is 0.3 % of the noise.
            check(ref_iter == model.summary.numIter and err_c <= 1e-6,
                  f"phase 21 kmeans vs the float64 Lloyd from the same seeded centres: "
                  f"{model.summary.numIter} vs {ref_iter} passes, centres max err {err_c:.3e} "
                  f"(tol 1e-6)")
            # Assignments at the fitted centres: the model's predict on the card
            # (the fold's scoring) against float64 at the same rounded centres.
            cm = torch.as_tensor(model.centers, device=DEV).to(cd).double()
            a64, margin = [], float("inf")
            for r0 in range(0, xk.shape[0], 1 << 18):
                xd = xk[r0:r0 + (1 << 18)].double()
                d2 = (xd * xd).sum(1)[:, None] + (cm * cm).sum(1)[None, :] - 2.0 * (xd @ cm.T)
                two = d2.topk(2, dim=1, largest=False).values
                margin = min(margin, float((two[:, 1] - two[:, 0]).min()))
                a64.append(d2.argmin(dim=1))
            a64 = torch.cat(a64)
            a_dev = model.predict(xk).long()
            same = int((a_dev == a64).sum())
            counts_dev = torch.bincount(a_dev, minlength=KM_K)
            counts64 = torch.bincount(a64, minlength=KM_K)
            check(same == xk.shape[0] and bool((counts_dev == counts64).all()),
                  f"phase 21 kmeans assignments at the fitted centres: {same} of {xk.shape[0]} "
                  f"equal to float64's, counts equal (integer-exact); smallest float64 margin "
                  f"{margin:.3e}, {int((counts64 > 0).sum())} centres hold rows")
            # The in-process fit_kmeans_stream of the same frames, its init scan
            # reading the same seed rows: the same f32 cost formula.
            head = {"first": True}
            frames = [xk[r0:r0 + DP_ROWS] for r0 in range(0, xk.shape[0], DP_ROWS)]

            def source():
                return iter([torch.from_numpy(sample)] if head.pop("first", False) else frames)

            sol = km.fit_kmeans_stream(source, KM_K, KM_D, max_iter=KM_MAX_ITER, tol=KM_TOL,
                                       seed=P21_SEED, init_sample_rows=seed_rows, device=DEV)
            err_s = float(np.abs(model.centers - sol.centers).max())
            cost_s = abs(model.summary.trainingCost - sol.cost) / sol.cost
            # Tolerance: the same per-frame f32 sums added in another order
            # (stages at commit): 1e-6 of the centres' noise-scale moves and
            # of the cost.
            check(sol.n_iter == model.summary.numIter and err_s <= 1e-6 and cost_s <= 1e-6,
                  f"phase 21 kmeans vs the in-process fit_kmeans_stream of the same frames from "
                  f"the same seed rows: {sol.n_iter} passes, centres max err {err_s:.3e}, cost rel "
                  f"err {cost_s:.3e} (tol 1e-6 each)")
            _, _, cost64 = lloyd_reference(torch, xk, model.centers, cd)
            cost_rel = abs(model.summary.trainingCost - cost64) / cost64
            # Tolerance: the f32 cost sums ‖x‖² + ‖c‖² − 2x·c per row (the JAX
            # formula); at blobs whose spread is 1e-4 of their separation those
            # terms are about 1e4 times the distance, and their f32 rounding,
            # shared by a blob's rows, does not cancel: it reads 2.4e-4 of the
            # cost here. 1e-3 relative still fails a cost off by a percent (a
            # missed slice of rows, a stale pass).
            check(cost_rel <= 1e-3,
                  f"phase 21 kmeans trainingCost {model.summary.trainingCost:.6e} vs float64 "
                  f"{cost64:.6e}: rel err {cost_rel:.3e} (tol 1e-3)")
            xq = xk[:DP_ROWS].cpu().numpy()
            del xk, a64, a_dev, frames
            p21_served(daemon, model, "kmeans", xq, "kmeans")
        finally:
            pool.close()
    torch.cuda.empty_cache()
    return out


def p22_fit(torch, kernels, est, profiling, pool, address, core, tag):
    """One phase-22 fit: the estimator's ``_drive_knn`` over the pool's one
    scan (partition SPARK_DYING's attempt 0 dies after a feed), counters
    reset just before it and read just after, traced for its device time.
    Returns (the ``_DaemonKNNModel``, a record of the run)."""
    from torch.profiler import ProfilerActivity, profile

    job = f"phase22-{tag}"
    fit = est._DaemonFit(*address, job)
    rec = {}
    finalize_knn = fit.client.finalize_knn

    def timed_finalize(*a, **kw):
        rec["status"] = fit.client.status(job)["rows"]
        t0 = time.perf_counter()
        rec["info"] = finalize_knn(*a, **kw)
        rec["build_s"] = time.perf_counter() - t0
        return rec["info"]

    fit.client.finalize_knn = timed_finalize

    def run_pass(pass_id):
        t0 = time.perf_counter()
        acks = pool.scan("knn", job, {}, pass_id, dies=True)
        rec["feed_s"] = time.perf_counter() - t0
        return acks

    torch.cuda.synchronize()
    kernels.reset_launches()
    profiling.reset_span_totals()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model = est._drive_knn(fit, run_pass, core)
        rec["s"] = time.perf_counter() - t0
        torch.cuda.synchronize()
    fit.close()
    rec["launches"], rec["routes"] = dict(kernels.LAUNCHES), dict(kernels.ROUTES)
    spans = profiling.span_totals()
    busy_ms, by_name, _ = device_time(torch, prof)
    del prof
    n = DP_PARTITIONS * DP_FEEDS * DP_ROWS
    built = int(rec["info"]["n_rows"][0])
    check(fit.total_fed == rec["status"] == built == model.numRows == n,
          f"phase 22 {tag}: acked {fit.total_fed}, status {rec['status']}, finalize n_rows "
          f"{built}, handle numRows {model.numRows} == {n} (the dying attempt's rows counted "
          f"nowhere)")
    frame_gib = (n + DP_ROWS) * KNN_D * 4 / 2 ** 30  # every frame and the dying attempt's one
    print(f"phase 22 {tag}: feed {n} rows x {KNN_D} in {rec['feed_s']:.3f} s = "
          f"{n / rec['feed_s']:.1f} rows/s, {frame_gib / rec['feed_s']:.2f} GiB/s of frames; "
          f"finalize (the index build) {rec['build_s']:.3f} s; fit {rec['s']:.3f} s (host clock)",
          flush=True)
    names = ("daemon frame receive", "daemon frame decode", "daemon stage rows",
             "daemon knn build", "kmeans init", "lloyd", "feed pass", "knn build")
    print(f"phase 22 {tag} spans (host-clock seconds summed over threads, count): "
          + ", ".join(f"{nm} {spans[nm][0]:.3f} ({spans[nm][1]})" for nm in names if nm in spans),
          flush=True)
    top = ", ".join(f"{nm[:40]} {ms:.3f} ({c})"
                    for nm, (ms, c) in sorted(by_name.items(), key=lambda r: -r[1][0])[:4])
    print(f"phase 22 {tag} device time (torch.profiler, CUDA activity): busy {busy_ms:.3f} ms of "
          f"{rec['s'] * 1e3:.3f} ms ({100 * busy_ms / (rec['s'] * 1e3):.2f} %); largest (ms, "
          f"count): {top or 'none'}", flush=True)
    return model, rec


def p22_served(torch, kernels, model, qs, tag):
    """Two served kneighbors calls through the handle (the first uploads
    the index): (distances, ids of the second, seconds of each, the
    launches of both)."""
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    model.kneighbors(qs)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    d, i = model.kneighbors(qs)
    s = time.perf_counter() - t0
    print(f"phase 22 served {tag} kneighbors: {qs.shape[0] / s:.1f} q/s ({s:.3f} s for "
          f"{qs.shape[0]} queries after a warm-up; the first call, with the index upload, "
          f"{first_s:.3f} s)", flush=True)
    return d, i, s, dict(kernels.LAUNCHES), dict(kernels.ROUTES)


def phase_knn_daemon(torch, kernels, config):
    """Phase 22: the knn job through the Spark feed protocol, the index
    built and served by the port's daemon on the card. Returns {kernel:
    launches} over its parts."""
    import numpy as np
    from concurrent.futures import ThreadPoolExecutor

    from spark_rapids_ml_tpu_torch import (
        ApproximateNearestNeighbors,
        NearestNeighbors,
        NearestNeighborsModel,
    )
    from spark_rapids_ml_tpu_torch.serve import DataPlaneDaemon
    from spark_rapids_ml_tpu_torch.spark import estimator as est
    from spark_rapids_ml_tpu_torch.utils import profiling

    n_rows = DP_PARTITIONS * DP_FEEDS * DP_ROWS
    print(f"phase 22: the knn job, {DP_PARTITIONS} task processes (forked, reused by both fits) "
          f"x {DP_FEEDS} feed_raw frames of {DP_ROWS} x {KNN_D} float32 rows of bench_knn.py's "
          f"{KNN_CLUSTERS}-component mixture from each task's seed: {n_rows} rows; partition "
          f"{SPARK_DYING}'s attempt 0 dies after one feed in each fit", flush=True)
    keys = [(p, f) for p in range(DP_PARTITIONS) for f in range(DP_FEEDS)]
    rows = np.empty((n_rows, KNN_D), np.float32)  # partition-major, as the daemon orders them

    def fill(i):
        rows[i * DP_ROWS:(i + 1) * DP_ROWS] = knn_frame(np, *keys[i], DP_ROWS, KNN_D,
                                                        KNN_CLUSTERS)

    with ThreadPoolExecutor(max_workers=8) as ex:
        list(ex.map(fill, range(len(keys))))
    qs = knn_frame(np, DP_PARTITIONS, 0, KNN_QUERIES, KNN_D, KNN_CLUSTERS)
    x_dev, q_dev = torch.from_numpy(rows).to(DEV), torch.from_numpy(qs).to(DEV)
    cd = config.compute_dtype(DEV)
    out = {}
    with DataPlaneDaemon(host="127.0.0.1", port=0, device=DEV) as daemon:
        t_spawn = time.perf_counter()
        pool = _P21Pool(daemon.address, P22_RUNS)
        try:
            pool.prepare("knn")
            print(f"phase 22 tasks ready (forked, imported the port, built their frames) in "
                  f"{time.perf_counter() - t_spawn:.1f} s", flush=True)

            # -- exact: the build stores the rows; dist_topk per served call ------
            core = NearestNeighbors(device=DEV).setK(KNN_K)
            model, rec = p22_fit(torch, kernels, est, profiling, pool, daemon.address, core,
                                 "exact")
            check(sum(rec["launches"].values()) == 0,
                  f"phase 22 exact fit: no kernel (the build stores the rows): {rec['launches']}")
            d_e, i_e, ex_s, launches, routes = p22_served(torch, kernels, model, qs, "exact")
            P22_SERVED["exact"] = (rec["build_s"], KNN_QUERIES / ex_s)
            P22_SERVED["exact_answer"] = (d_e, i_e)  # phase 27's one-daemon answer
            check(launches["dist_topk"] == 2 and routes["dist_topk/wgmma"] == 2
                  and sum(launches.values()) == 2,
                  f"phase 22 served exact kneighbors: dist_topk launches {launches['dist_topk']} "
                  f"== 2 calls, on the tensor-core route ({routes['dist_topk/wgmma']}), no other "
                  f"kernel")
            out["dist_topk"] = launches["dist_topk"]
            ref = NearestNeighborsModel(database=rows, device=DEV)._set(k=KNN_K)
            ref.kneighbors(qs)  # the index upload
            t0 = time.perf_counter()
            rd, ri = ref.kneighbors(qs)
            ref_s = time.perf_counter() - t0
            check_equal(torch, torch.as_tensor(i_e), torch.as_tensor(ri),
                        "phase 22 served exact ids vs the in-process NearestNeighborsModel")
            rel = float(np.max(np.abs(d_e - rd) / np.maximum(np.abs(rd), 1e-30)))
            check(rel <= 1e-6, f"phase 22 served exact distances vs in-process: max rel err "
                               f"{rel:.3e} (tol 1e-6)")
            xr, qr = x_dev.to(cd), q_dev.to(cd)
            gt_d, gt_i = brute_force64(torch, xr, qr, KNN_K)
            # Tolerance: phase 16's, 4e-6 of the largest ‖q‖² + ‖r‖² of the
            # rounded rows (f32 sums over 768 products).
            scale = (float(kernels.row_sq_norms(qr).max())
                     + float(kernels.row_sq_norms(xr).max()))
            tol = 4e-6 * scale
            del xr, qr
            for tag, (dd, ii) in (("served", (d_e, i_e)), ("in-process", (rd, ri))):
                check_selection(torch, f"phase 22 {tag} exact vs float64 of the same "
                                f"{str(cd)[6:]} rows (tol {tol:.2e})",
                                torch.as_tensor(dd, device=DEV) ** 2,
                                torch.as_tensor(ii, device=DEV), gt_d, gt_i, tol)
            inproc = INPROC_QPS.get("exact")
            print(f"phase 22 exact q/s: served {KNN_QUERIES / ex_s:.1f}, in-process "
                  f"NearestNeighborsModel {KNN_QUERIES / ref_s:.1f} (this phase), phase 16 "
                  f"{'not run' if inproc is None else f'{inproc:.1f}'}", flush=True)
            device_breakdown(torch, "phase 22 served exact kneighbors trace",
                             lambda: model.kneighbors(qs))
            check(model.release(), "phase 22: the exact index released")
            del ref, gt_d, gt_i, d_e, i_e, rd, ri
            torch.cuda.empty_cache()

            # -- IVF: the build at finalize, probe + scan per served call ---------
            core = (ApproximateNearestNeighbors(device=DEV).setK(KNN_K).setNlist(KNN_NLIST)
                    .setNprobe(KNN_NPROBE))
            amodel, rec = p22_fit(torch, kernels, est, profiling, pool, daemon.address, core,
                                  "ivf")
            b, r = rec["launches"], rec["routes"]
            kernels.reset_launches()
            t0 = time.perf_counter()
            ann = (ApproximateNearestNeighbors(device=DEV).setK(KNN_K).setNlist(KNN_NLIST)
                   .setNprobe(KNN_NPROBE).fit({"features": rows}))
            ref_build_s = time.perf_counter() - t0
            rb = dict(kernels.LAUNCHES)
            print(f"phase 22 ivf build launches: lloyd_step {b['lloyd_step']}, assign_min_dist "
                  f"{b['assign_min_dist']}, dist_topk {b['dist_topk']}; the in-process build of "
                  f"the same rows {ref_build_s:.3f} s, launches {rb['lloyd_step']}, "
                  f"{rb['assign_min_dist']}, {rb['dist_topk']}", flush=True)
            check(b["lloyd_step"] == rb["lloyd_step"] == r["lloyd_step/wgmma"] == 10,
                  f"phase 22 ivf build: lloyd_step {b['lloyd_step']} == 10 (the quantizer's "
                  f"iterations, as in process), all wgmma")
            check(b["assign_min_dist"] == rb["assign_min_dist"]
                  and r["assign_min_dist/wgmma"] == 1
                  and r["assign_min_dist/ffma"] == b["assign_min_dist"] - 1
                  and b["assign_min_dist"] >= 1 + -(-n_rows // (1 << 18)),
                  f"phase 22 ivf build: assign_min_dist {b['assign_min_dist']} as in process, the "
                  f"quantizer's cost pass on the tensor-core route and the f32 chunks on FFMA")
            check(r["dist_topk/ffma"] == b["dist_topk"] and r["dist_topk/wgmma"] == 0
                  and sum(b.values()) == b["lloyd_step"] + b["assign_min_dist"] + b["dist_topk"],
                  f"phase 22 ivf build: its {b['dist_topk']} f32 dist_topk launches (spill "
                  f"candidates) on the FFMA route, no other kernel")
            for name in ("lloyd_step", "assign_min_dist"):
                out[name] = b[name]
            out["dist_topk"] += b["dist_topk"]
            served = daemon._lookup_model(amodel.daemon_model_name).model
            same_lists = np.array_equal(served.index.list_ids, ann.index.list_ids)
            print(f"phase 22 ivf: the daemon's list_ids equal the in-process build's: "
                  f"{same_lists} (information: the Lloyd sums' order may differ); maxlen "
                  f"{int(rec['info']['maxlen'][0])} vs {ann.index.lists.shape[1]}", flush=True)
            d_a, i_a, ivf_s, launches, routes = p22_served(torch, kernels, amodel, qs, "ivf")
            P22_SERVED["ivf"] = (rec["build_s"], KNN_QUERIES / ivf_s)
            check(launches["probe_select"] == 2 and routes["probe_select/fused"] == 2
                  and launches["ivf_scan_select"] == 2 and routes["ivf_scan_select/wgmma"] == 2,
                  f"phase 22 served ivf kneighbors: probe_select {launches['probe_select']} == 2 "
                  f"calls, fused ({routes['probe_select/fused']}); ivf_scan_select "
                  f"{launches['ivf_scan_select']} == 2, tensor-core "
                  f"({routes['ivf_scan_select/wgmma']})")
            out["probe_select"] = launches["probe_select"]
            out["ivf_scan_select"] = launches["ivf_scan_select"]
            gt_d, gt_i = brute_force64(torch, x_dev, q_dev, KNN_K)
            ann.kneighbors(qs)  # the index upload
            t0 = time.perf_counter()
            _, i_r = ann.kneighbors(qs)
            ann_s = time.perf_counter() - t0
            rec_d, rec_r = recall_at(i_a, gt_i), recall_at(i_r, gt_i)
            P22_SERVED["ivf_recall"] = rec_d  # phase 27's one-daemon recall
            check(abs(rec_d - rec_r) <= 0.005,
                  f"phase 22 ivf recall@{KNN_K} vs float64 ground truth: served {rec_d:.4f}, the "
                  f"in-process build of the same rows, seed and nlist {rec_r:.4f} (within 0.005)")
            ids = torch.as_tensor(i_a, device=DEV)
            got = torch.as_tensor(d_a, device=DEV) ** 2
            r64 = x_dev[ids.clamp_min(0).reshape(-1)].double().reshape(KNN_QUERIES, KNN_K, KNN_D)
            own = ((r64 - q_dev.double()[:, None, :]) ** 2).sum(2)
            del r64
            # Tolerance: phase 15's for f32 distances of f32 rows, 4e-6 of the
            # largest ‖q‖² + ‖r‖²: the rerank recomputes each from the stored
            # f32 row, so a wrong id (a row id off its partition-major place)
            # would miss by the whole distance.
            atol = 4e-6 * (float(kernels.row_sq_norms(q_dev).max())
                           + float(kernels.row_sq_norms(x_dev).max()))
            err = float((got - own).abs().max())
            check(bool((ids >= 0).all()) and err <= atol,
                  f"phase 22 ivf: every returned id's distance vs float64 of ‖q − rows[id]‖² "
                  f"(partition-major ids): max err {err:.3e} (tol {atol:.2e})")
            inproc = INPROC_QPS.get("ivf")
            print(f"phase 22 ivf q/s (nprobe {KNN_NPROBE}): served {KNN_QUERIES / ivf_s:.1f}, "
                  f"in-process {KNN_QUERIES / ann_s:.1f} (this phase), phase 17 "
                  f"{'not run' if inproc is None else f'{inproc:.1f}'}", flush=True)
            device_breakdown(torch, "phase 22 served ivf kneighbors trace",
                             lambda: amodel.kneighbors(qs), top=6)
            served._set(nprobe=KNN_NLIST)
            kernels.reset_launches()
            _, i_all = amodel.kneighbors(qs)
            rec_all = recall_at(i_all, gt_i)
            check(rec_all >= 0.98 and kernels.ROUTES["probe_select/sort"] == 1,
                  f"phase 22 ivf every list probed (nprobe {KNN_NLIST}): recall@{KNN_K} "
                  f"{rec_all:.4f} >= 0.98, its probe on the sort route")
            check(amodel.release(), "phase 22: the ivf index released")
            del ann, gt_d, gt_i, served
        finally:
            pool.close()
    del x_dev, q_dev
    torch.cuda.empty_cache()
    return out


def scaler_rows(torch, gen, n, d):
    """Phase 23's rows, float32 on the card: a rank-K factor model (factor
    scales √(2 − j/(K−1)), loadings N(0, 1/K)) plus noise 0.5·N(0, 1) and
    column means 0.05·N(0, 1), so every column has unit scale and the
    standardized rows keep K eigenvalues 1.6 % apart above the noise."""
    lam = torch.sqrt(2.0 - torch.arange(K, device=DEV, dtype=torch.float32) / (K - 1))
    w = torch.randn((K, d), generator=gen, device=DEV) / K ** 0.5
    mu = 0.05 * torch.randn((d,), generator=gen, device=DEV)
    x = torch.randn((n, d), generator=gen, device=DEV)
    x *= 0.5
    x.addmm_(torch.randn((n, K), generator=gen, device=DEV) * lam, w)
    x += mu
    return x


def column_moments64(torch, x, block=256):
    """(mean, unbiased std) of x's columns in float64 on the card, a block
    of columns at a time."""
    mean, std = [], []
    for j in range(0, x.shape[1], block):
        xd = x[:, j:j + block].double()
        mean.append(xd.mean(0))
        std.append(xd.std(0, unbiased=True))
    return torch.cat(mean), torch.cat(std)


def scaler_recompute(np, x, mean, std, with_mean):
    """The MLlib transform from fitted statistics, in numpy float64."""
    out = np.asarray(x, np.float64)
    if with_mean:
        out = out - mean
    inv = np.where(std > 0, 1.0 / np.where(std > 0, std, 1.0), 0.0)
    return (out * inv).astype(np.float32)


def auc64(np, y, score):
    """Area under the ROC curve from pair counts in float64 numpy: for each
    positive, the negatives below it plus half those tied with it."""
    pos = score[y > 0.5]
    neg = np.sort(score[y <= 0.5])
    below = np.searchsorted(neg, pos, side="left").astype(np.float64)
    tied = np.searchsorted(neg, pos, side="right") - below
    return float((below + 0.5 * tied).sum() / (pos.size * neg.size))


def ridge_rmse64(torch, x, y, folds, reg):
    """CrossValidator's average validation rmse of a ridge fit (the port's
    normal equations: centred XᵀX/n + reg·I) recomputed in float64 on the
    card over the same folds."""
    parts = []
    for val in folds:
        xv, yv = x[val].double(), y[val].double()
        parts.append((xv.T @ xv, xv.T @ yv, xv.sum(0), yv.sum(), float(len(val)), xv, yv))
    tot = [sum(p[i] for p in parts) for i in range(5)]
    out = []
    for xtx, xty, sx, sy, n, xv, yv in parts:
        a_, b_, sx_, sy_, n_ = tot[0] - xtx, tot[1] - xty, tot[2] - sx, tot[3] - sy, tot[4] - n
        mx, my = sx_ / n_, sy_ / n_
        a = (a_ - torch.outer(mx, sx_)) / n_
        b = (b_ - sx_ * my) / n_
        w = torch.linalg.solve(a + reg * torch.eye(a.shape[0], dtype=a.dtype, device=a.device), b)
        pred = xv @ w + (my - mx @ w)
        out.append(float(torch.sqrt(((yv - pred) ** 2).mean())))
    return sum(out) / len(out)


def phase_estimators(torch, kernels, config):
    """Phase 23, in process: StandardScaler, Pipeline(StandardScaler → PCA),
    CrossValidator(LinearRegression) and TrainValidationSplit(binomial
    LogisticRegression) through the port's estimators on the card. Returns
    {kernel: launches} of these paths."""
    import tempfile

    import numpy as np

    from spark_rapids_ml_tpu_torch import (
        PCA, BinaryClassificationEvaluator, CrossValidator, LinearRegression,
        LogisticRegression, ParamGridBuilder, Pipeline, PipelineModel, RegressionEvaluator,
        StandardScaler, TrainValidationSplit,
    )

    t_phase = time.perf_counter()
    gen = torch.Generator(device=DEV).manual_seed(P23_SEED)
    launches = {}
    # -- the in-memory scaler ------------------------------------------------
    x = scaler_rows(torch, gen, SC_ROWS, D)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sc = StandardScaler().fit({"features": x})
    sc_s = time.perf_counter() - t0  # the statistics are on the host: synced
    mean64, std64 = (t.cpu().numpy() for t in column_moments64(torch, x))
    err_std = float(np.abs(sc.std / std64 - 1.0).max())
    err_mean = float((np.abs(sc.mean - mean64) / std64).max())
    # Tolerance: unit-scale columns summed in float32 (pairwise on the card)
    # over 1,048,576 rows; the Σx² − nμ² form loses nothing at |μ| ≪ σ.
    check(err_std <= 1e-6 and err_mean <= 1e-6,
          f"StandardScaler fit of {SC_ROWS} x {D} f32 rows: std rel err vs float64 "
          f"{err_std:.2e}, mean err over std {err_mean:.2e} (tol 1e-6 each)")
    xq = x[:TRANSFORM_ROWS].cpu().numpy()
    for with_mean in (False, True):
        m = sc.copy({"withMean": with_mean})
        got = m.transform_matrix(x[:TRANSFORM_ROWS])["output"]
        want = scaler_recompute(np, xq, m.mean, m.std, with_mean)
        check(got.dtype == np.float32 and np.array_equal(got, want),
              f"scaler transform (withMean={with_mean}) of {TRANSFORM_ROWS} rows bitwise equal to "
              f"a numpy float64 recompute from the fitted mean and std")
    print(f"StandardScaler fit: {SC_ROWS} x {D} f32 in {sc_s:.3f} s "
          f"({SC_ROWS / sc_s:.1f} rows/s, host clock, first call)", flush=True)

    # -- Pipeline(StandardScaler -> PCA) ---------------------------------------
    pipe = Pipeline(stages=[StandardScaler().setWithMean(True).setOutputCol("scaled"),
                            PCA().setInputCol("scaled").setK(K)])
    kernels.reset_launches()
    t0 = time.perf_counter()
    pm = pipe.fit({"features": x})
    pipe_s = time.perf_counter() - t0
    launches["gram"] = kernels.LAUNCHES["gram"]
    check(launches["gram"] == 1 and kernels.ROUTES["gram/wgmma"] == 1,
          f"Pipeline fit: gram launches {launches['gram']} == 1 (the PCA stage), on the "
          f"tensor-core route ({kernels.ROUTES['gram/wgmma']} wgmma)")
    scaled = pm.stages[0].transform_matrix(x)["output"]  # the stage's output, on the host
    alone_sc = StandardScaler().setWithMean(True).fit({"features": x})
    check(np.array_equal(alone_sc.mean, pm.stages[0].mean)
          and np.array_equal(alone_sc.std, pm.stages[0].std),
          "the pipeline's scaler stage equals a stage-by-stage fit, bitwise")
    alone = PCA().setK(K).fit({"features": scaled})
    # The tensor-core Gram's row splits meet in no fixed order (gram.cu), so
    # two fits of the same rows agree to the last bits of their f32 sums:
    # held at phase 3's tolerance, with the bitwise outcome printed.
    d_alone = sign_aligned_err(pm.stages[1].pc, torch.as_tensor(alone.pc, device=DEV))
    check(d_alone <= 1e-3, f"the pipeline's PCA stage vs a stage-by-stage fit of the same rows: "
                           f"max sign-aligned diff {d_alone:.3e} (tol 1e-3; bitwise: "
                           f"{bool(np.array_equal(pm.stages[1].pc, alone.pc))})")
    xd = torch.from_numpy(scaled).to(DEV).to(torch.bfloat16).double()  # what the fit reads
    pc_ref, _, gap = reference_pca(torch.tensor(float(SC_ROWS), dtype=torch.float64, device=DEV),
                                   xd.sum(0), xd.T @ xd, K)
    del xd
    err = sign_aligned_err(pm.stages[1].pc, pc_ref)
    check(err <= 1e-3, f"pipeline pc vs float64 PCA of the standardized bf16 rows: max "
                       f"sign-aligned err {err:.3e} (tol 1e-3; eigengap {gap:.3e})")
    t0 = time.perf_counter()
    out = pm.transform({"features": x[:TRANSFORM_ROWS]})
    pipe_tf_ms = (time.perf_counter() - t0) * 1e3
    check(tuple(out["pca_features"].shape) == (TRANSFORM_ROWS, K)
          and np.array_equal(out["scaled"], scaled[:TRANSFORM_ROWS]),
          f"pipeline transform of {TRANSFORM_ROWS} rows: the scaled column equals the stage's "
          f"output, pca_features {tuple(out['pca_features'].shape)}")
    with tempfile.TemporaryDirectory() as tmp:
        pm.save(os.path.join(tmp, "pm"))
        back = PipelineModel.load(os.path.join(tmp, "pm"))
    check(back.uid == pm.uid and [s.uid for s in back.stages] == [s.uid for s in pm.stages]
          and np.array_equal(back.stages[0].mean, pm.stages[0].mean)
          and np.array_equal(back.stages[0].std, pm.stages[0].std)
          and np.array_equal(back.stages[1].pc, pm.stages[1].pc)
          and back.stages[0].getWithMean() and back.stages[1].getK() == K,
          "PipelineModel save and load round-trips bitwise (uids, params, arrays)")
    print(f"Pipeline(StandardScaler -> PCA k={K}) fit: {SC_ROWS} x {D} in {pipe_s:.3f} s (the "
          f"scaler's host float64 transform of the rows included); transform of "
          f"{TRANSFORM_ROWS} rows {pipe_tf_ms:.1f} ms", flush=True)
    del x, scaled, pm, alone, out, back
    torch.cuda.empty_cache()

    # -- CrossValidator(LinearRegression) ---------------------------------------
    xc = torch.randn((CV_ROWS, CV_D), generator=gen, device=DEV).to(torch.bfloat16)
    w_true = torch.randn((CV_D,), generator=gen, device=DEV) / CV_D ** 0.5
    yc = xc.float() @ w_true + 0.5 + 0.1 * torch.randn((CV_ROWS,), generator=gen, device=DEV)
    lr = LinearRegression()
    grid = ParamGridBuilder().addGrid(lr.regParam, list(CV_REGS)).build()
    cv = CrossValidator(lr, grid, RegressionEvaluator(), numFolds=CV_FOLDS, seed=P23_SEED)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    cvm = cv.fit({"features": xc, "label": yc})
    cv_s = time.perf_counter() - t0
    launches["linreg_stats"] = kernels.LAUNCHES["linreg_stats"]
    fits = CV_FOLDS * len(CV_REGS) + 1
    print(f"CrossValidator linreg_stats launches {launches['linreg_stats']}, routes "
          f"{ {k: v for k, v in kernels.ROUTES.items() if k.startswith('linreg_stats/')} }")
    check(launches["linreg_stats"] == fits and kernels.ROUTES["linreg_stats/wgmma"] == fits,
          f"CrossValidator: linreg_stats launches {launches['linreg_stats']} == {fits} fits, "
          f"all on the tensor-core route")
    perm = np.random.default_rng(P23_SEED).permutation(CV_ROWS)
    folds = [torch.as_tensor(np.sort(perm[f::CV_FOLDS]), device=DEV) for f in range(CV_FOLDS)]
    ref = [ridge_rmse64(torch, xc, yc, folds, reg) for reg in CV_REGS]
    err = max(abs(a / b - 1.0) for a, b in zip(cvm.avgMetrics, ref))
    # Tolerance: the fit's f32 normal equations (5e-7 of the Gram) and the
    # served product with its coefficients rounded to bf16 (2⁻⁹ each, about
    # 6e-5 of an rmse of 0.1 here).
    check(err <= 1e-3, f"CrossValidator avgMetrics {['%.6f' % v for v in cvm.avgMetrics]} vs a "
                       f"float64 ridge recompute over the same folds "
                       f"{['%.6f' % v for v in ref]}: max rel err {err:.2e} (tol 1e-3)")
    best = int(np.argmin(ref))
    check(cvm.bestModel.getRegParam() == CV_REGS[best],
          f"CrossValidator's best regParam {cvm.bestModel.getRegParam()} == the float64 argmin "
          f"{CV_REGS[best]}")
    print(f"CrossValidator(LinearRegression, {len(CV_REGS)} maps x {CV_FOLDS} folds + refit): "
          f"{CV_ROWS} x {CV_D} bf16 in {cv_s:.3f} s ({fits} fits)", flush=True)
    del xc, yc, folds, cvm
    torch.cuda.empty_cache()

    # -- TrainValidationSplit(binomial LogisticRegression) -------------------------
    xl = torch.randn((TVS_ROWS, TVS_D), generator=gen, device=DEV).to(torch.bfloat16)
    w_true = torch.randn((TVS_D,), generator=gen, device=DEV) / TVS_D ** 0.5
    yl = (torch.rand((TVS_ROWS,), generator=gen, device=DEV)
          < torch.sigmoid(xl.float() @ w_true + 0.3)).float()
    seen = []

    class Recording(BinaryClassificationEvaluator):
        def evaluate(self, dataset):
            seen.append((np.asarray(dataset["label"].cpu().numpy(), np.float64),
                         self._score(dataset)))
            return super().evaluate(dataset)

    lg = LogisticRegression()
    grid = ParamGridBuilder().addGrid(lg.regParam, list(TVS_REGS)).build()
    tvs = TrainValidationSplit(lg, grid, Recording(), trainRatio=TVS_RATIO, seed=P23_SEED)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    tvm = tvs.fit({"features": xl, "label": yl})
    tvs_s = time.perf_counter() - t0
    launches["newton_stats"] = kernels.LAUNCHES["newton_stats"]
    routes = {k: v for k, v in kernels.ROUTES.items() if k.startswith("newton_stats/")}
    print(f"TrainValidationSplit newton_stats launches {launches['newton_stats']}, routes {routes}")
    check(launches["newton_stats"] > 0 and routes["newton_stats/wgmma"] == launches["newton_stats"],
          f"TrainValidationSplit: {launches['newton_stats']} newton_stats launches over "
          f"{len(TVS_REGS) + 1} fits, all on the tensor-core route")
    aucs = [auc64(np, y, s) for y, s in seen]
    err = max(abs(a - b) for a, b in zip(tvm.validationMetrics, aucs))
    check(len(seen) == len(TVS_REGS) and err <= 1e-12,
          f"TrainValidationSplit areaUnderROC {['%.6f' % v for v in tvm.validationMetrics]} vs a "
          f"float64 numpy AUC of the same scores: max abs err {err:.2e} (tol 1e-12)")
    print(f"TrainValidationSplit(LogisticRegression, {len(TVS_REGS)} maps + refit): "
          f"{TVS_ROWS} x {TVS_D} bf16 in {tvs_s:.3f} s", flush=True)
    del xl, yl, tvm
    torch.cuda.empty_cache()
    print(f"phase 23, in process: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def phase_spark_scaler(torch, kernels, config, spark_rate):
    """Phase 23, the Spark part: SparkStandardScaler's feed protocol through
    the port's daemon on the card, with ``_drive_scaler`` as the driver and
    phase 20's 8 forked tasks and frames. Returns the gram_colsum
    launches."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from spark_rapids_ml_tpu_torch.models.scaler import StandardScaler
    from spark_rapids_ml_tpu_torch.serve import DataPlaneClient, DataPlaneDaemon
    from spark_rapids_ml_tpu_torch.spark import estimator as est
    from spark_rapids_ml_tpu_torch.utils import profiling

    print(f"phase 23 SparkStandardScaler: {DP_PARTITIONS} task processes (forked) x {DP_FEEDS} "
          f"feed_raw frames of {DP_ROWS} x {D} float32 (phase 20's bf16-exact rows); partition "
          f"{SPARK_DYING}'s attempt 0 dies after one feed", flush=True)
    core = StandardScaler()
    t_phase = time.perf_counter()
    with DataPlaneDaemon(host="127.0.0.1", port=0, device=DEV) as daemon:
        t_spawn = time.perf_counter()
        pool = _P21Pool(daemon.address, P23_RUNS)
        print(f"phase 23 tasks ready in {time.perf_counter() - t_spawn:.1f} s", flush=True)
        try:
            model, rec = p21_fit(torch, kernels, est, profiling, pool, daemon.address, "scaler",
                                 lambda fit, run_pass: est._drive_scaler(fit, run_pass, core),
                                 runs=P23_RUNS, tag="phase 23")
        finally:
            pool.close()
        launches = rec["launches"]["gram_colsum"]
        folded = DP_PARTITIONS * DP_FEEDS + 1
        check(launches == folded and rec["routes"]["gram_colsum/wgmma"] == folded,
              f"phase 23 SparkStandardScaler: gram_colsum launches {launches} == folded feeds "
              f"{folded}, all on the tensor-core route")
        # References from the same rows, rebuilt from the tasks' seeds.
        s1 = torch.zeros(D, dtype=torch.float64, device=DEV)
        s2 = torch.zeros(D, dtype=torch.float64, device=DEV)
        sa = torch.zeros(D, dtype=torch.float64, device=DEV)
        keys = [(p, f) for p in range(DP_PARTITIONS) for f in range(DP_FEEDS)]
        with ThreadPoolExecutor(max_workers=8) as rows_pool:
            for x in rows_pool.map(lambda pf: spark_rows(np, pf[0], pf[1], DP_ROWS, D, K), keys):
                xd = torch.from_numpy(x).to(DEV).double()
                s1 += xd.sum(0)
                s2 += (xd * xd).sum(0)
                sa += xd.abs().sum(0)
        n = float(rec["rows"])
        mean64 = (s1 / n).cpu().numpy()
        var64 = ((s2 - n * (s1 / n) ** 2) / (n - 1)).cpu().numpy()
        ex2, eabs = (s2 / n).cpu().numpy(), (sa / n).cpu().numpy()
        err_m = float((np.abs(model.mean - mean64) / eabs).max())
        err_v = float((np.abs(model.std ** 2 - var64) / ex2).max())
        # Tolerance: the fold's f32 sums (the tensor-core Gram's diagonal at
        # 5e-7 of Σx²), so the variance is held to E[x²], not to itself
        # (phase 20's tail columns have |μ| up to 10 σ).
        check(err_m <= 1e-6 and err_v <= 2e-6,
              f"SparkStandardScaler mean vs float64 of the same rows: {err_m:.2e} of E|x| (tol "
              f"1e-6); variance {err_v:.2e} of E[x²] (tol 2e-6)")
        xq = spark_rows(np, 0, 0, DP_ROWS, D, K)
        names = []
        for with_mean in (False, True):
            m = model.copy({"withMean": with_mean})
            name = f"{m.uid}-{est._model_fingerprint(m)}"
            with DataPlaneClient(*daemon.address) as c:
                created = c.ensure_model(name, "scaler", m._model_data(),
                                         params=est._scalar_params(m))
            got = daemon._lookup_model(name).transform(xq)["output"]
            check(created and np.array_equal(got, m.transform_matrix(xq)["output"]),
                  f"served scaler (withMean={with_mean}) of {DP_ROWS} rows through ensure_model "
                  f"bitwise equal to transform_matrix")
            names.append(name)
        check(len(set(names)) == 2 and len(daemon._models) == 2,
              f"the withMean=True copy registered under a second name: {names}")
        served = daemon._lookup_model(names[0])
        lat = []
        for _ in range(21):
            t0 = time.perf_counter()
            served.transform(xq)
            lat.append((time.perf_counter() - t0) * 1e3)
        lat.sort()
    gib = (rec["rows"] + DP_ROWS) * D * 4 / 2 ** 30
    beside = ("not run" if spark_rate is None else f"{spark_rate:.1f} rows/s in this run")
    print(f"phase 23 SparkStandardScaler: {rec['rows'] / rec['s']:.1f} rows/s, "
          f"{gib / rec['s']:.2f} GiB/s of frames (phase 20's PCA fit of the same frames: "
          f"{beside}); served scaler p50 {lat[len(lat) // 2]:.3f} ms for {DP_ROWS} x {D} host "
          f"rows (host clock, 21 runs); phase 23's Spark part {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches


def rf_rows(torch, gen, rows, kind):
    """Phase 24's synthetic rows on the card, in the public datasets' shapes.

    ``higgs``: 28 float32 features, 21 "low-level" N(0, 1) ones and 7
    "high-level" ones built from them (√(a² + b²) + 0.3·N(0, 1), as HIGGS's
    invariant masses are functions of its kinematics), and a 0/1 label drawn
    from a logistic model of both kinds. ``msd``: 90 float32 features (12
    timbre means at scales 5-40, 78 covariances N(0, 1)) and integer year
    labels 1922-2011 from a saturating function of them plus noise."""
    if kind == "higgs":
        x = torch.randn((rows, HIGGS_D), generator=gen, device=DEV)
        hi = torch.sqrt(x[:, 0:7] ** 2 + x[:, 7:14] ** 2)
        x[:, 21:28] = hi + 0.3 * x[:, 21:28]
        logit = (1.2 * (x[:, 21] - 1.25) - 0.8 * (x[:, 22] - 1.25) + 0.6 * x[:, 3] * x[:, 4]
                 + 0.4 * x[:, 5] - 0.3 * x[:, 24])
        y = (torch.rand((rows,), generator=gen, device=DEV) < torch.sigmoid(logit)).float()
        return x, y
    scales = torch.ones(MSD_D, device=DEV)
    scales[:12] = torch.linspace(5.0, 40.0, 12, device=DEV)
    x = torch.randn((rows, MSD_D), generator=gen, device=DEV) * scales
    s = x[:, :12] / scales[:12]
    z = torch.tanh(0.5 * s[:, 0] - 0.4 * s[:, 1] + 0.3 * s[:, 2] * s[:, 3]) + 0.2 * x[:, 12]
    year = 1998.0 + 9.0 * z + 3.0 * torch.randn((rows,), generator=gen, device=DEV)
    return x, torch.clamp(torch.round(year), 1922.0, 2011.0)


def np_bootstrap(np, n, tree, seed):
    """One tree's Poisson(1) bag weights of rows 0..n−1 of partition 0, in
    numpy uint32 (wrapping) arithmetic: the reference's hash, written
    independently of the port's int64 form."""
    def mix(h):
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(0x7FEB352D)
        h = h ^ (h >> np.uint32(15))
        h = h * np.uint32(0x846CA68B)
        return h ^ (h >> np.uint32(16))

    tweak = np.uint32((tree * 0x9E3779B1 + (seed & 0xFFFFFFFF)) & 0xFFFFFFFF)
    u = mix(np.arange(n, dtype=np.uint32) ^ mix(np.array([tweak], np.uint32)))
    u = u.astype(np.float32) * np.float32(1.0 / 4294967296.0)
    w = np.zeros(n, np.float64)
    for c in np.asarray([0.36787944117144233, 0.7357588823428847, 0.9196986029286058,
                         0.9810118431238462, 0.9963401531726563, 0.9994058151824183],
                        np.float32):
        w += u > c
    return w


def np_forest(np, arrays, xq):
    """A numpy descent of the fitted tables (binned in float32, as the card
    bins): per-tree leaf stats (T, n, S), float64."""
    feature = np.asarray(arrays["feature"], np.int64)
    threshold = np.asarray(arrays["threshold"], np.int64)
    value = np.asarray(arrays["value"], np.float64)
    edges = np.asarray(arrays["bin_edges"], np.float64).astype(np.float32)
    bins = (xq[:, :, None] > edges[None, :, :]).sum(-1)
    T, N = feature.shape
    n, d = bins.shape
    idx = np.zeros((T, n), np.int64)
    rows = np.arange(n)[None, :]
    for _ in range(int(np.log2(N + 1)) - 1):
        f = np.take_along_axis(feature, idx, 1)
        bin_at = bins[rows, np.clip(f, 0, d - 1)]
        go = (bin_at > np.take_along_axis(threshold, idx, 1)).astype(np.int64)
        idx = np.where(f >= 0, 2 * idx + 1 + go, idx)
    return value[np.arange(T)[:, None], idx]


def rf_node_tie(torch, hist_ops, bins, y, weights, cpu, spec, t, node, pick):
    """Whether the card's decision at heap node ``node`` of tree ``t`` is a
    near-tie with the CPU's, on the CPU fit's tables: the node's histogram
    rebuilt in float64 on the card from its rows (``bins``, ``y``, the bag
    ``weights`` (T, n)) and scored in the Σg²/n form the scorer maximizes.
    With both sides split, the card's (feature, bin) ``pick`` must score
    within RF_TIE of the best candidate; with one side a leaf (``pick``
    None, or the CPU's node a leaf), the best candidate must score within
    RF_TIE of the node's own term (a gain float32 cannot resolve). Returns
    (tie, best, picked or the node's term)."""
    depth = (node + 1).bit_length() - 1
    W = 1 << depth
    feat = torch.from_numpy(cpu["feature"][t:t + 1]).to(DEV)
    thr = torch.from_numpy(cpu["threshold"][t:t + 1]).to(DEV)
    idx, alive = hist_ops.descend_to_frontier(bins, feat, thr, depth)
    sel = (idx[0] == node) & alive[0]
    w, yy, b = weights[t][sel], y[sel], bins[sel].long()
    d, B = b.shape[1], spec.max_bins
    hist = torch.zeros((d * B, 3), dtype=torch.float64, device=DEV)
    key = (torch.arange(d, device=DEV)[None, :] * B + b).reshape(-1)
    src = torch.stack([w, w * yy, w * yy * yy], 1)[:, None, :].expand(-1, d, 3).reshape(-1, 3)
    hist.index_add_(0, key, src)
    cum = hist.view(d, B, 3).cumsum(1)
    left, right = cum[:, : B - 1], cum[:, B - 1:B] - cum[:, : B - 1]
    n_l, n_r = left[..., 0], right[..., 0]
    raw = left[..., 1] ** 2 / n_l.clamp(min=1) + right[..., 1] ** 2 / n_r.clamp(min=1)
    subset = hist_ops.feature_subset_mask(spec.num_trees, W, depth, d, spec.subset_m,
                                          spec.seed, device=DEV)[t, node - (W - 1)]
    valid = (n_l >= spec.min_instances) & (n_r >= spec.min_instances) & subset[:, None]
    raw = torch.where(valid, raw, torch.full_like(raw, -float("inf")))
    best = float(raw.max())
    if pick is None or int(cpu["feature"][t, node]) < 0:
        tot = cum[0, B - 1]
        own = float(tot[1] ** 2 / tot[0].clamp(min=1))
        return best <= own * (1.0 + RF_TIE), best, own
    picked = float(raw[pick[0], pick[1]])
    return picked >= best * (1.0 - RF_TIE), best, picked


def rf_compare(torch, np, hist_ops, tag, card, cpu, bins, y, weights, spec):
    """The card's prefix fit against the CPU's: classifier tables bitwise;
    regressor features and thresholds equal and values within 1e-5
    relative, except under a node whose decisions differ by a near-tie
    (``rf_node_tie``; printed, then its subtree skipped)."""
    if spec.n_classes > 0:
        same = all(np.array_equal(card[k], cpu[k]) for k in ("feature", "threshold", "value"))
        check(same, f"{tag}: card and CPU (float32) fits of the {RF_PREFIX}-row prefix: "
                    f"feature, threshold and value bitwise equal")
        return
    T, N = cpu["feature"].shape
    skip = np.zeros((T, N), bool)
    ties, bad = [], []
    for node in range(N):
        kids = [c for c in (2 * node + 1, 2 * node + 2) if c < N]
        for t in range(T):
            if skip[t, node]:
                for c in kids:
                    skip[t, c] = True
                continue
            vc, vg = cpu["value"][t, node], card["value"][t, node]
            if not np.all(np.abs(vg - vc) <= 1e-5 * np.abs(vc)):
                bad.append((t, node, "value"))
            fc, fg = int(cpu["feature"][t, node]), int(card["feature"][t, node])
            tc, tg = int(cpu["threshold"][t, node]), int(card["threshold"][t, node])
            if (fc, tc) == (fg, tg):
                continue
            tie = None
            if fc >= 0 or fg >= 0:
                tie, best, picked = rf_node_tie(torch, hist_ops, bins, y, weights, cpu, spec,
                                                t, node, (fg, tg) if fg >= 0 else None)
            if tie:
                ties.append((t, node, (fc, tc), (fg, tg), best, picked))
                for c in kids:
                    skip[t, c] = True
            else:
                bad.append((t, node, (fc, tc), (fg, tg)))
    for t, node, c, g, best, picked in ties:
        if c[0] >= 0 and g[0] >= 0:
            print(f"  {tag} near-tie: tree {t} node {node}: CPU split {c}, card {g}; the card's "
                  f"candidate scores {picked:.10e} against the best {best:.10e} "
                  f"({1 - picked / best:.2e} below; tie tol {RF_TIE})")
        else:
            print(f"  {tag} near-tie: tree {t} node {node}: CPU {c}, card {g} (-1: a leaf); the "
                  f"best candidate scores {best:.10e} against the node's own {picked:.10e} "
                  f"({best / picked - 1:.2e} above; tie tol {RF_TIE})")
    check(not bad, f"{tag}: card and CPU (float32) fits of the {RF_PREFIX}-row prefix: features "
                   f"and thresholds equal, values within 1e-5 relative, outside {len(ties)} "
                   f"near-tie subtrees; mismatches {bad[:8]}")


def rf_fit_timed(torch, kernels, profiling, fit, tag, n):
    """One full-size forest fit with the spans reset before it and a
    torch.profiler trace of its device activity around it: prints fit
    seconds, rows/s per level pass, the histogram and split ms per level and
    the device busy share. (Device events only: a fit makes some 10⁵ host
    ops, whose trace would take longer to read than the fit.)"""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    kernels.reset_launches()
    profiling.reset_span_totals()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model = fit()
        fit_s = time.perf_counter() - t0  # the tables are on the host: synced
    busy_ms, by_name, _ = device_time(torch, prof)
    del prof
    spans = profiling.span_totals()
    hs, passes = spans.get("forest histogram", (0.0, 0))
    ss, _ = spans.get("forest split", (0.0, 0))
    bs, _ = spans.get("forest binning", (0.0, 0))
    top = ", ".join(f"{nm[:44]} {ms:.1f} ({c})"
                    for nm, (ms, c) in sorted(by_name.items(), key=lambda r: -r[1][0])[:5])
    print(f"{tag} fit: {n} rows in {fit_s:.3f} s, {passes} level passes, "
          f"{n * passes / max(hs, 1e-9):.1f} rows/s per level pass of the histogram; per level: "
          f"histogram {1e3 * hs / max(passes, 1):.1f} ms, split {1e3 * ss / max(passes, 1):.1f} "
          f"ms (spans, host clock); binning {bs:.3f} s; device busy {busy_ms:.1f} ms of "
          f"{fit_s * 1e3:.1f} ({100 * busy_ms / (fit_s * 1e3):.1f} %); largest device kernels "
          f"(ms, count): {top}", flush=True)
    assert not any(kernels.LAUNCHES.values()), "a forest fit launches no hand-written kernel"
    return model


def phase_forests(torch, kernels, config):
    """Phase 24: RandomForestClassifier on HIGGS's shape and
    RandomForestRegressor on YearPredictionMSD's, Spark's defaults, on the
    card; the checks at a 131,072-row prefix against the card machine's CPU
    and at full size against numpy."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from spark_rapids_ml_tpu_torch import RandomForestClassifier, RandomForestRegressor
    from spark_rapids_ml_tpu_torch.models import random_forest as rf
    from spark_rapids_ml_tpu_torch.ops import histogram as hist_ops
    from spark_rapids_ml_tpu_torch.utils import profiling

    t_phase = time.perf_counter()
    marks = []  # (what, seconds into the phase)

    def mark(what):
        marks.append((what, time.perf_counter() - t_phase))

    gen = torch.Generator(device=DEV).manual_seed(RF_SEED)
    xh, yh = rf_rows(torch, gen, HIGGS_ROWS, "higgs")
    xhq, yhq = rf_rows(torch, gen, RF_HELDOUT, "higgs")
    xm, ym = rf_rows(torch, gen, MSD_ROWS, "msd")
    xmq, ymq = rf_rows(torch, gen, RF_HELDOUT, "msd")
    mark("data")
    print(f"phase 24: RandomForestClassifier on {HIGGS_ROWS} x {HIGGS_D} (UCI HIGGS's shape, "
          f"{float(yh.mean()):.3f} positive) and RandomForestRegressor on {MSD_ROWS} x {MSD_D} "
          f"(UCI YearPredictionMSD's shape, years {int(ym.min())}-{int(ym.max())}), synthesized "
          f"from seed {RF_SEED}; Spark's defaults: numTrees 20, maxDepth 5, maxBins 32, "
          f"featureSubsetStrategy auto, bootstrap", flush=True)
    kw = dict(seed=RF_SEED)
    xh_cpu, yh_cpu = xh[:RF_PREFIX].cpu(), yh[:RF_PREFIX].cpu()
    xm_cpu, ym_cpu = xm[:RF_PREFIX].cpu(), ym[:RF_PREFIX].cpu()

    def cpu_fits():  # the card machine's CPU, float32 as on the card
        return (rf.fit_random_forest_classifier(xh_cpu, yh_cpu, device="cpu", **kw),
                rf.fit_random_forest_regressor(xm_cpu, ym_cpu, device="cpu", **kw))

    clf = rf_fit_timed(torch, kernels, profiling, lambda: RandomForestClassifier().setSeed(
        RF_SEED).fit({"features": xh, "label": yh}), "RandomForestClassifier (HIGGS shape)",
        HIGGS_ROWS)
    reg = rf_fit_timed(torch, kernels, profiling, lambda: RandomForestRegressor().setSeed(
        RF_SEED).fit({"features": xm, "label": ym}), "RandomForestRegressor (MSD shape)",
        MSD_ROWS)
    mark("timed fits")
    # The CPU prefix fits run in a thread (their torch ops leave the
    # interpreter lock) beside everything the card does below; after the
    # timed fits, whose spans they would add to.
    with ThreadPoolExecutor(max_workers=1) as pool:
        t_cpu = time.perf_counter()
        cpu_job = pool.submit(cpu_fits)
        card_c = rf.fit_random_forest_classifier(xh[:RF_PREFIX], yh[:RF_PREFIX], **kw)
        card_r = rf.fit_random_forest_regressor(xm[:RF_PREFIX], ym[:RF_PREFIX], **kw)
        # Every tree's root class totals: numpy float64 sums of the host
        # bootstrap weights per class (integer-exact), a tree per thread.
        yh_np = yh.cpu().numpy().astype(np.int64)
        spec_c = rf.forest_spec_from_params({"n_classes": 2, "seed": RF_SEED}, HIGGS_D)
        with ThreadPoolExecutor(max_workers=4) as trees:
            want = list(trees.map(lambda t: np.bincount(
                yh_np, weights=np_bootstrap(np, HIGGS_ROWS, t, RF_SEED), minlength=2),
                range(spec_c.num_trees)))
        roots_ok = all(np.array_equal(clf.arrays["value"][t, 0], want[t])
                       for t in range(spec_c.num_trees))
        check(roots_ok, f"classifier: every tree's root class totals equal numpy float64 sums of "
                        f"the host bootstrap weights per class ({HIGGS_ROWS} rows, "
                        f"{spec_c.num_trees} trees; tree 0: {clf.arrays['value'][0, 0].tolist()})")
        msd_w = [np_bootstrap(np, MSD_ROWS, t, RF_SEED).sum() for t in range(spec_c.num_trees)]
        check(all(reg.arrays["value"][t, 0, 0] == msd_w[t] for t in range(spec_c.num_trees)),
              "regressor: every tree's root count equals the numpy sum of its bootstrap weights")
        # Held-out transform against a numpy descent of the fitted tables.
        xq = xhq.cpu().numpy()
        leaves = np_forest(np, clf.arrays, xq)
        proba = (leaves / np.maximum(leaves.sum(-1, keepdims=True), 1.0)).mean(0)
        got = clf.transform_matrix(xhq)["prediction"].cpu().numpy()
        top2 = np.sort(proba, 1)
        near = top2[:, -1] - top2[:, -2] <= 1e-6
        same = got == proba.argmax(1)
        check(bool(same[~near].all()),
              f"classifier transform_matrix of {RF_HELDOUT} held-out rows: predicted class equal "
              f"to a numpy descent of the tables on every row off a 1e-6 near-tie "
              f"({int(near.sum())} near-ties, {int((~same & near).sum())} of them differing)")
        lm = np_forest(np, reg.arrays, xmq.cpu().numpy())
        means = (lm[..., 1] / np.maximum(lm[..., 0], 1.0)).mean(0)
        got_r = reg.transform_matrix(xmq)["prediction"].cpu().numpy()
        err_r = float(np.abs(got_r / means - 1.0).max())
        check(err_r <= 1e-6, f"regressor transform_matrix of {RF_HELDOUT} held-out rows vs a "
                             f"numpy descent: max rel err {err_r:.2e} (tol 1e-6)")
        acc = float((got == yhq.cpu().numpy()).mean())
        ymq_np = ymq.cpu().numpy().astype(np.float64)
        r2 = 1.0 - float(((got_r - ymq_np) ** 2).sum() / ((ymq_np - ymq_np.mean()) ** 2).sum())
        lat = {}
        for tag, model, q in (("classifier", clf, xhq), ("regressor", reg, xmq)):
            runs = []
            for _ in range(21):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model.transform_matrix(q)["prediction"].sum().item()
                runs.append(time.perf_counter() - t0)
            lat[tag] = sorted(runs)[10]
        print(f"forest predict of {RF_HELDOUT} held-out rows (device-resident, synced, p50 of 21): "
              f"classifier {RF_HELDOUT / lat['classifier']:.1f} rows/s, accuracy {acc:.4f}; "
              f"regressor {RF_HELDOUT / lat['regressor']:.1f} rows/s, R² {r2:.4f}", flush=True)
        mark("the card's checks")
        cpu_c, cpu_r = cpu_job.result()
        cpu_s = time.perf_counter() - t_cpu
        mark("the CPU prefix fits")
    spec_r = rf.forest_spec_from_params({"seed": RF_SEED}, MSD_D)
    rf_compare(torch, np, hist_ops, "classifier", card_c.arrays, cpu_c.arrays, None, None, None,
               spec_c)
    edges = torch.as_tensor(cpu_r.arrays["bin_edges"], device=DEV).float()
    bins = hist_ops.bin_matrix(xm[:RF_PREFIX], edges)
    keys = torch.arange(RF_PREFIX, dtype=torch.int64, device=DEV)
    weights = hist_ops.bootstrap_weights(keys, spec_r.num_trees, spec_r.seed).double()
    rf_compare(torch, np, hist_ops, "regressor", card_r.arrays, cpu_r.arrays, bins,
               ym[:RF_PREFIX].double(), weights, spec_r)
    mark("the prefix comparisons")
    print(f"phase 24: {time.perf_counter() - t_phase:.1f} s (the CPU prefix fits "
          f"{cpu_s:.1f} s beside the card's work; done at: "
          + ", ".join(f"{what} {sec:.1f} s" for what, sec in marks) + ")", flush=True)


def p25_fit(torch, kernels, est, profiling, pool, address, run, core, sample, sp_rate):
    """One phase-25 Spark forest fit: ``spark/estimator._drive_forest`` over
    the pool's passes (partition SPARK_DYING's attempt 0 dies after a feed
    in the first), the counters and spans reset just before it and read
    just after, scan P25_TRACED_PASS traced (CUDA activity) for the device
    busy share. Checks the rows of every pass, the depths and that no
    hand-written kernel launched. Returns (model, a record of the run)."""
    from torch.profiler import ProfilerActivity, profile

    _, d, _, _, n_classes, n = P25_RUNS[run]
    pool.prepare(run)
    job = f"phase25-{run}"
    fit = est._DaemonFit(*address, job)
    rec = {"scans": 0, "scan_s": [], "step_s": [], "infos": [], "busy": None}
    real_finalize, real_step = fit.finalize_guarded, fit.step

    def guarded(params, pass_rows_expected=None):
        rec["status"] = fit.client.status(job)["rows"]
        arrays, rows = real_finalize(params, pass_rows_expected)
        rec["finalize"] = rows
        return arrays, rows

    def step(pass_id, rows, params=None):
        t0 = time.perf_counter()
        info = real_step(pass_id, rows, params)  # held to the scan's acked rows
        rec["step_s"].append(time.perf_counter() - t0)
        rec["infos"].append(info)
        return info

    def run_pass(pass_id):
        rec["scans"] += 1
        t0 = time.perf_counter()
        if rec["scans"] != P25_TRACED_PASS:
            acks = pool.scan(run, job, fit.params, pass_id, dies=rec["scans"] == 1)
        else:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                acks = pool.scan(run, job, fit.params, pass_id, dies=False)
                torch.cuda.synchronize()
            rec["traced_s"] = time.perf_counter() - t0
            rec["busy"] = device_time(torch, prof)[:2]
            del prof
        rec["scan_s"].append(time.perf_counter() - t0)
        return acks

    fit.finalize_guarded, fit.step = guarded, step
    torch.cuda.synchronize()
    kernels.reset_launches()
    profiling.reset_span_totals()
    t0 = time.perf_counter()
    model = est._drive_forest(fit, run_pass, core, sample, n_classes)
    rec["s"] = time.perf_counter() - t0
    fit.close()
    rec["launches"] = dict(kernels.LAUNCHES)
    spans = profiling.span_totals()
    tag = f"phase 25 {run}"
    scans, infos = rec["scans"], rec["infos"]
    check(fit.total_fed == rec["status"] == rec["finalize"] == n * scans
          and all(i["pass_rows"] == n for i in infos),
          f"{tag}: acked {fit.total_fed}, status {rec['status']}, finalize {rec['finalize']} rows "
          f"== {scans} scans x {n}, every step's pass_rows {n} (the dying attempt's rows "
          f"counted nowhere)")
    depths = [int(i["depth"]) for i in infos]
    check(depths == list(range(1, scans + 1)) and scans <= core.getMaxDepth()
          and int(infos[-1]["open_nodes"]) == 0,
          f"{tag}: step depths {depths} (open nodes "
          f"{[int(i['open_nodes']) for i in infos]}, splits {[int(i['splits']) for i in infos]}) "
          f"until none is open, within maxDepth {core.getMaxDepth()} passes")
    print(f"{tag} kernel counters (reset before the fit): {rec['launches']}", flush=True)
    check(not any(rec["launches"].values()),
          f"{tag}: no hand-written kernel launched (the reference's forest path reaches no "
          f"Pallas kernel)")
    row_bytes = d * 4 + 8  # float32 features, a float64 label
    gib = (n * scans + min(DP_ROWS, rf_part_rows(n, SPARK_DYING))) * row_bytes / 2 ** 30
    beside = ("not run" if sp_rate is None else
              f"{sp_rate:.1f} rows/s, {sp_rate * D * 4 / 2 ** 30:.2f} GiB/s")
    feed_s = sum(rec["scan_s"])
    print(f"{tag}: {n} rows x {d}, {scans} passes, fit {rec['s']:.3f} s: "
          f"{n * scans / feed_s:.1f} rows/s fed over the scans ({feed_s:.3f} s), "
          f"{gib / feed_s:.2f} GiB/s of frames (phase 20's PCA frames in this run: {beside}); "
          f"{1e3 * feed_s / scans:.1f} ms per pass (scan), "
          f"{1e3 * sum(rec['step_s']) / scans:.1f} ms per step (host clock)", flush=True)
    names = ("daemon frame receive", "daemon frame decode", "daemon host to device",
             "daemon fold", "forest histogram", "daemon commit", "daemon step", "forest split",
             "feed pass", "seed", "step", "finalize")
    print(f"{tag} spans (host-clock seconds summed over threads, count): "
          + ", ".join(f"{nm} {spans[nm][0]:.3f} ({spans[nm][1]})" for nm in names if nm in spans),
          flush=True)
    if rec["busy"] is not None:
        busy_ms, by_name = rec["busy"]
        top = ", ".join(f"{nm[:40]} {ms:.3f} ({c})"
                        for nm, (ms, c) in sorted(by_name.items(), key=lambda r: -r[1][0])[:4])
        wall = rec["traced_s"] * 1e3
        print(f"{tag} device time of scan {P25_TRACED_PASS} (torch.profiler, CUDA activity): "
              f"busy {busy_ms:.3f} ms of {wall:.3f} ms ({100 * busy_ms / wall:.2f} %); largest "
              f"(ms, count): {top or 'none'}", flush=True)
    return model, rec


def p25_check_bags(np, pool, run, model):
    """Every tree's root statistics (the classifier's per-class counts, the
    regressor's count) against the tasks' float64 sums of their rows' bag
    weights at the partition-relative keys."""
    spec = model.getNumTrees(), RF_SEED, P25_RUNS[run][4]
    want = np.sum(pool.bags(run, *spec), axis=0)
    root = np.asarray(model.arrays["value"])[:, 0, :want.shape[1]]
    check(np.array_equal(root, want),
          f"phase 25 {run}: every tree's root {'class counts' if spec[2] else 'count'} equal "
          f"the float64 sums of the bag weights of row_identity_keys(partition, offset) over "
          f"all {P25_RUNS[run][5]} rows ({spec[0]} trees; tree 0: {root[0].tolist()})")


def p25_local_fit(np, est, address, core, n_classes, frames, tag):
    """A forest fit of one frame a partition through the daemon at
    ``address``: ``_drive_forest`` with each pass's partitions fed by
    threads of this process through the Spark feed task's body, the edges
    from the first DP_ROWS rows partition-major. Returns the model."""
    from concurrent.futures import ThreadPoolExecutor

    from spark_rapids_ml_tpu_torch.serve import DataPlaneClient

    job = f"phase25-{tag}"
    fit = est._DaemonFit(*address, job)

    def feed(p, pass_id):
        with DataPlaneClient(*address, timeout=900.0) as c:
            def send(b):
                c.feed_raw(job, b[0], b[1], algo="rf", params=fit.params, partition=p,
                           pass_id=pass_id)

            return est._feed_partition(c, [frames[p]], send, job, p, 0, pass_id, address)

    def run_pass(pass_id):
        with ThreadPoolExecutor(max_workers=len(frames)) as tp:
            return list(tp.map(lambda p: feed(p, pass_id), range(len(frames))))

    sample = np.concatenate([x for x, _ in frames])[:DP_ROWS]
    try:
        return est._drive_forest(fit, run_pass, core, sample, n_classes)
    finally:
        fit.close()


def phase_forest_daemon(torch, kernels, config, sp_rate):
    """Phase 25: SparkRandomForestClassifier on HIGGS's shape and
    SparkRandomForestRegressor on YearPredictionMSD's through the port's
    daemon on the card, Spark's defaults: the estimators' driver function
    over 8 forked task processes, then the card against a CPU daemon on a
    prefix, a direct-feed daemon fit against the in-process fit, and the
    served forests."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from spark_rapids_ml_tpu_torch import RandomForestClassifier, RandomForestRegressor
    from spark_rapids_ml_tpu_torch.models import random_forest as rf
    from spark_rapids_ml_tpu_torch.ops import histogram as hist_ops
    from spark_rapids_ml_tpu_torch.serve import DataPlaneClient, DataPlaneDaemon
    from spark_rapids_ml_tpu_torch.spark import estimator as est
    from spark_rapids_ml_tpu_torch.utils import profiling

    t_phase = time.perf_counter()
    marks = []  # (what, seconds into the phase)

    def mark(what):
        marks.append((what, time.perf_counter() - t_phase))

    print(f"phase 25: the forests through the daemon, {DP_PARTITIONS} task processes (spawn, "
          f"reused across passes) x feed_raw frames of {DP_ROWS} (x float32, y float64) rows, "
          f"HIGGS's shape ({P25_RUNS['higgs'][5]} x {HIGGS_D}, 2 classes) and "
          f"YearPredictionMSD's ({P25_RUNS['msd'][5]} x {MSD_D}, integer years) from seed "
          f"{RF_SEED}; Spark's defaults (numTrees 20, maxDepth 5, maxBins 32, auto subsets, "
          f"bootstrap); partition {SPARK_DYING}'s attempt 0 dies after one feed in each fit's "
          f"first scan", flush=True)
    cores = {"higgs": (RandomForestClassifier(device=DEV).setSeed(RF_SEED), 2),
             "msd": (RandomForestRegressor(device=DEV).setSeed(RF_SEED), 0)}
    models = {}
    with DataPlaneDaemon(host="127.0.0.1", port=0, device=DEV) as daemon:
        t_spawn = time.perf_counter()
        pool = _P21Pool(daemon.address, P25_RUNS)
        print(f"phase 25 tasks ready in {time.perf_counter() - t_spawn:.1f} s", flush=True)
        mark("spawn")
        try:
            for run in ("higgs", "msd"):
                # The driver's prefix sample: the first DP_ROWS rows, partition-major.
                head = []
                for p in range(DP_PARTITIONS):
                    head.append(rf_frame(np, P25_RUNS, run, p, 0)[0])
                    if sum(h.shape[0] for h in head) >= DP_ROWS:
                        break
                sample = np.concatenate(head)[:DP_ROWS]
                models[run], _ = p25_fit(torch, kernels, est, profiling, pool, daemon.address,
                                         run, cores[run][0], sample, sp_rate)
                mark(f"the {run} fit")
                p25_check_bags(np, pool, run, models[run])
                mark(f"the {run} bags")
        finally:
            pool.close()

        # -- the card against the CPU on a prefix in the same layout --------------
        half = RF_PREFIX // DP_PARTITIONS
        prefix = {run: [tuple(a[:half] for a in rf_frame(np, P25_RUNS, run, p, 0))
                        for p in range(DP_PARTITIONS)] for run in ("higgs", "msd")}

        def cpu_fits():  # the card machine's CPU, float32 as on the card
            with DataPlaneDaemon(host="127.0.0.1", port=0, device="cpu") as cpu_daemon:
                return {run: p25_local_fit(
                    np, est, cpu_daemon.address,
                    (RandomForestClassifier if run == "higgs" else RandomForestRegressor)(
                        device="cpu").setSeed(RF_SEED), cores[run][1], prefix[run],
                    f"cpu-{run}") for run in ("higgs", "msd")}

        with ThreadPoolExecutor(max_workers=1) as bg:
            t_cpu = time.perf_counter()
            cpu_job = bg.submit(cpu_fits)
            card = {run: p25_local_fit(np, est, daemon.address, cores[run][0], cores[run][1],
                                       prefix[run], f"prefix-{run}")
                    for run in ("higgs", "msd")}
            mark("the card's prefix fits")

            # -- direct feeds against the in-process fit -------------------------
            frames = [rf_frame(np, P25_RUNS, "higgs", 0, f) for f in range(P25_DIRECT_FRAMES)]
            x = np.concatenate([a for a, _ in frames])
            y = np.concatenate([b for _, b in frames])
            params = est._forest_params(cores["higgs"][0], 2)
            spec = rf.forest_spec_from_params(params, HIGGS_D)
            edges = hist_ops.quantile_bin_edges(
                x[:int(config.get("forest_seed_sample_rows"))].astype(np.float64), spec.max_bins)
            job = "phase25-direct"
            t0 = time.perf_counter()
            with DataPlaneClient(*daemon.address) as c:
                c.set_iterate(job, rf.init_forest_arrays(spec, edges), 0, algo="rf",
                              n_cols=HIGGS_D, params=params)
                for it in range(spec.max_depth + 1):
                    for xf, yf in frames:  # in order: the offsets are the row indices
                        c.feed_raw(job, xf, yf, algo="rf", params=params, pass_id=it)
                    if int(c.step(job)["open_nodes"]) == 0:
                        break
                direct, rows = c.finalize(job, {})
            direct_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            inproc = RandomForestClassifier(device=DEV).setSeed(RF_SEED).fit(
                {"features": torch.from_numpy(x).to(DEV), "label": torch.from_numpy(y).to(DEV)})
            inproc_s = time.perf_counter() - t0
            n_iter = int(direct.pop("n_iter")[0])
            same = sorted(direct) == sorted(inproc.arrays) and all(
                np.array_equal(direct[k], inproc.arrays[k]) for k in inproc.arrays)
            check(same and rows == x.shape[0] * n_iter,
                  f"phase 25 direct feeds: {x.shape[0]} HIGGS-shape rows as {len(frames)} "
                  f"partition-less feed_raw frames a pass, {n_iter} passes ({direct_s:.3f} s), "
                  f"bitwise equal to the in-process RandomForestClassifier.fit of the same rows "
                  f"on the card ({inproc_s:.3f} s): {sorted(inproc.arrays)}")
            mark("the direct-feed fit")

            # -- the served forests -------------------------------------------------
            served, held = {}, {}
            for run, algo in (("higgs", "rf_classifier"), ("msd", "rf_regressor")):
                xq, yq = rf_frame(np, P25_RUNS, run, DP_PARTITIONS, 0, rows=RF_HELDOUT)
                name = f"phase25-{algo}"
                with DataPlaneClient(*daemon.address) as c:
                    created = c.ensure_model(name, algo, models[run]._model_data())
                served[run] = daemon._lookup_model(name)
                got = served[run].transform(xq)["prediction"]
                want = models[run].transform_matrix(xq)["prediction"]
                check(created and got.dtype == want.dtype == np.float64
                      and np.array_equal(got, want),
                      f"phase 25 served {algo} of {RF_HELDOUT} held-out rows through "
                      f"ensure_model bitwise equal to transform_matrix")
                held[run] = (xq, yq, got)
            mark("the served forests")
            cpu = cpu_job.result()
            cpu_s = time.perf_counter() - t_cpu
            mark("the CPU prefix fits")
        lat = {}
        for run in ("higgs", "msd"):
            runs = []
            for _ in range(21):
                t0 = time.perf_counter()
                served[run].transform(held[run][0])
                runs.append(time.perf_counter() - t0)
            lat[run] = sorted(runs)[10] * 1e3
    _, yq, got = held["higgs"]
    acc = float((got == yq).mean())
    _, yq, got = held["msd"]
    r2 = 1.0 - float(((got - yq) ** 2).sum() / ((yq - yq.mean()) ** 2).sum())
    print(f"phase 25 served forests, {RF_HELDOUT} held-out host rows (host clock, p50 of 21): "
          f"classifier {lat['higgs']:.3f} ms, accuracy {acc:.4f}; regressor {lat['msd']:.3f} ms, "
          f"R² {r2:.4f}", flush=True)
    for run, tag in (("higgs", "classifier"), ("msd", "regressor")):
        xp = torch.from_numpy(np.concatenate([a for a, _ in prefix[run]])).to(DEV)
        yp = torch.from_numpy(np.concatenate([b for _, b in prefix[run]])).to(DEV)
        spec = rf.forest_spec_from_params(est._forest_params(cores[run][0], cores[run][1]),
                                          xp.shape[1])
        keys = np.concatenate([rf.row_identity_keys(p, 0, half) for p in range(DP_PARTITIONS)])
        keys = torch.from_numpy(keys.astype(np.int64)).to(DEV)
        bins = hist_ops.bin_matrix(xp, torch.as_tensor(cpu[run].arrays["bin_edges"],
                                                       device=DEV).float())
        weights = hist_ops.bootstrap_weights(keys, spec.num_trees, spec.seed).double()
        rf_compare(torch, np, hist_ops, f"phase 25 {tag} (daemon, {DP_PARTITIONS} partitions)",
                   card[run].arrays, cpu[run].arrays, bins, yp.double(), weights, spec)
    print(f"phase 25: {time.perf_counter() - t_phase:.1f} s (the CPU daemon's prefix fits "
          f"{cpu_s:.1f} s beside the card's work; done at: "
          + ", ".join(f"{what} {sec:.1f} s" for what, sec in marks) + ")", flush=True)


# -- 26. the fits across processes -------------------------------------------------

P3_ROWS = (N_BATCHES - 1) * BATCH_ROWS + LAST_BATCH_ROWS  # phase 3's stream
P26_RANK_TIMEOUT_S = 420  # each spawned rank's time limit; past it the smoke kills it
P26_SPLIT = (5, 3)  # phase 3's (and phase 9's) eight batches: rank 0's, rank 1's
P26_MN_SPLIT = 80_000  # phase 12's rows: rank 0 takes the first 80,000, rank 1 the rest
P26_SMALL_ROWS = 1 << 15  # the binomial and KMeans streams' rows a rank
P26_KM_K = 16
#: The kernels of the slice's path, as the kernels JSON names them.
P26_KERNELS = ("gram", "gram_colsum", "linreg_stats", "softmax_curvature", "dist_topk")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _digest(*arrays) -> str:
    """A hash of the arrays' bytes: equal on two ranks iff bitwise equal."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(np.asarray(a)).tobytes())
    return h.hexdigest()[:16]


def _state_digest(state) -> str:
    return _digest(*(t.detach().cpu().numpy() for t in state))


def phase3_rows(torch):
    """Phase 3's generator, spectrum and eight bf16 batches, replayed from
    its seed: (generator, scales, mu, batches)."""
    gen = torch.Generator(device=DEV).manual_seed(0)
    j = torch.arange(D, device=DEV, dtype=torch.float32)
    scales = torch.where(j < K, torch.sqrt(2.0 - j / (K - 1)), 0.1 * 0.999 ** j)
    mu = 0.05 * torch.randn((D,), generator=gen, device=DEV)
    batches = [make_rows(gen, LAST_BATCH_ROWS if b == N_BATCHES - 1 else BATCH_ROWS,
                         scales, mu, torch.bfloat16) for b in range(N_BATCHES)]
    return gen, scales, mu, batches


def int_batches(torch, which):
    """Small-integer bf16 rows {-1, 0, 1} at phase 3's batch shapes, batch b
    from seed 2600 + b: every Gram and column sum of all eight batches is an
    integer below 2^24, so any order of f32 adds gives the same bits."""
    for b in which:
        g = torch.Generator(device=DEV).manual_seed(2600 + b)
        rows = LAST_BATCH_ROWS if b == N_BATCHES - 1 else BATCH_ROWS
        yield torch.randint(-1, 2, (rows, D), generator=g, device=DEV).to(torch.bfloat16)


def gram64(torch, batches, cd=None):
    """float64 (count, colsum, gram) of row batches on the card (each cast
    to ``cd`` first when given), in 131,072-row chunks."""
    count, colsum = 0.0, None
    gram = None
    for b in batches:
        for r0 in range(0, b.shape[0], 1 << 17):
            xd = (b[r0:r0 + (1 << 17)] if cd is None else b[r0:r0 + (1 << 17)].to(cd)).double()
            gram = xd.T @ xd if gram is None else gram.add_(xd.T @ xd)
            colsum = xd.sum(0) if colsum is None else colsum.add_(xd.sum(0))
            count += xd.shape[0]
    return torch.tensor(count, dtype=torch.float64, device=DEV), colsum, gram


def _p26_nccl(port, q) -> None:
    """Phase 26a, in a spawned process: an NCCL world of one on cuda:0."""
    try:
        import torch

        from spark_rapids_ml_tpu_torch.models.pca import fit_pca_stream
        from spark_rapids_ml_tpu_torch.ops import gram as gram_ops
        from spark_rapids_ml_tpu_torch.ops import kernels
        from spark_rapids_ml_tpu_torch.ops import selection as sel
        from spark_rapids_ml_tpu_torch.parallel import distributed
        from spark_rapids_ml_tpu_torch.parallel import mapreduce as mr

        distributed.initialize_cluster(f"127.0.0.1:{port}", 1, 0, backend="nccl")
        mesh = distributed.global_mesh()
        check(mesh.backend == "nccl" and mesh.collective and mesh.device.type == "cuda",
              f"26a: an NCCL world of one on {mesh.device}")
        g = torch.Generator(device=DEV).manual_seed(260)
        x = torch.randn((4096, 33), generator=g, device=DEV)
        ok_sum = torch.equal(mr.reduce_sum(x.clone(), mesh=mesh), x)
        ok_cat = torch.equal(mr.all_concat(x, axis=1, mesh=mesh), x)
        pool_d = torch.randint(0, 4, (64, 12), generator=g, device=DEV).float()
        pool_i = torch.randperm(64 * 12, generator=g, device=DEV).reshape(64, 12).int()
        got = mr.reduce_topk(pool_d, pool_i, 10, mesh=mesh)
        want = sel.lex_topk(pool_d, pool_i, 10)
        ok_topk = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        check(ok_sum and ok_cat and ok_topk and all(v == 0 for v in mr.STAGED.values()),
              "26a: NCCL reduce_sum, all_concat and reduce_topk of CUDA tensors equal their "
              "inputs (world of one), nothing staged")
        # The stream's fold through the world's all_reduce, against the fold
        # of no world (seeded), on small-integer rows: bitwise.
        solo = gram_ops.init_stats(D, device=DEV)
        world = gram_ops.init_stats(D, device=DEV)
        kernels.reset_launches()
        for xb in int_batches(torch, range(N_BATCHES)):
            gram_ops.streaming_update_rows(solo, xb, xb.shape[0])
            gram_ops.streaming_update_rows(world, xb, xb.shape[0], mesh=mesh)
        check(all(torch.equal(a, b) for a, b in zip(solo, world))
              and kernels.ROUTES["gram_colsum/wgmma"] == 2 * N_BATCHES,
              f"26a: phase 3's shapes on small-integer rows: the state through NCCL's "
              f"all_reduce bitwise equal to the fold without a world "
              f"({kernels.ROUTES['gram_colsum/wgmma']} wgmma launches)")
        _, _, _, batches = phase3_rows(torch)
        kernels.reset_launches()
        sol = fit_pca_stream(batches, k=K, n_cols=D, mesh=mesh)
        launches = kernels.LAUNCHES["gram_colsum"]
        pc_ref, ev_ref, _ = reference_pca(*gram64(torch, batches), K)
        err = sign_aligned_err(sol.pc, pc_ref)
        ev_err = float((torch.as_tensor(sol.explained_variance, device=DEV) - ev_ref).abs().max())
        check(launches == N_BATCHES and err <= 1e-3 and ev_err <= 1e-4,
              f"26a: fit_pca_stream of phase 3's batches through mesh=global_mesh() (NCCL): "
              f"{launches} gram_colsum launches, pc err {err:.3e} (tol 1e-3), explained "
              f"variance err {ev_err:.3e} (tol 1e-4) against phase 3's float64 reference")
        distributed.shutdown_cluster()
        q.put(("ok", "nccl", None))
    except BaseException as e:  # noqa: BLE001 - reported to the parent
        q.put(("err", "nccl", repr(e)))
        raise


def _p26_probe(rank, port, q) -> None:
    """Phase 26's record of gloo's send/recv of CUDA tensors, in a world of
    its own (a refusal can break the pair's connection)."""
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank)
    x = torch.full((4,), float(rank), device=DEV)
    r = torch.empty_like(x)
    try:
        ops = [dist.P2POp(dist.isend, x, 1 - rank), dist.P2POp(dist.irecv, r, 1 - rank)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        torch.cuda.synchronize()
        q.put((rank, "took", r.tolist()))
    except RuntimeError as e:  # the record: what gloo refused
        q.put((rank, "refused", str(e).splitlines()[0][:200]))


def _p26_rank(rank, port, q) -> None:
    """Phase 26b's rank, in a spawned process: reports its numbers to the
    parent over ``q`` and exits non-zero on a failed check."""
    try:
        out = _p26_body(rank, port)
        q.put(("ok", rank, out))
    except BaseException as e:  # noqa: BLE001 - a failed check exits; reported to the parent
        q.put(("err", rank, repr(e)))
        raise


def _p26_body(rank, port) -> dict:
    import torch

    from spark_rapids_ml_tpu_torch import config
    from spark_rapids_ml_tpu_torch.models import kmeans as km
    from spark_rapids_ml_tpu_torch.models import linear_regression as lr
    from spark_rapids_ml_tpu_torch.models import logistic_regression as lg
    from spark_rapids_ml_tpu_torch.models import pca
    from spark_rapids_ml_tpu_torch.models.knn import NearestNeighbors
    from spark_rapids_ml_tpu_torch.ops import gram as gram_ops
    from spark_rapids_ml_tpu_torch.ops import kernels
    from spark_rapids_ml_tpu_torch.parallel import distributed
    from spark_rapids_ml_tpu_torch.parallel import mapreduce as mr
    from spark_rapids_ml_tpu_torch.parallel.sharding import lockstep_batches, lockstep_labeled_batches
    from spark_rapids_ml_tpu_torch.utils import profiling

    torch.set_num_threads(2)
    distributed.initialize_cluster(f"127.0.0.1:{port}", 2, rank, backend="gloo")
    mesh = distributed.global_mesh()
    tag = f"26b rank {rank}:"
    out = {"launches": {}, "digests": {}}
    # One process's fits, the references of the streams and of kneighbors:
    # rank 0 runs them after it leaves the world (a fit inside the world
    # would wait for the other rank in the lockstep's gathers).
    after = []

    def barrier():
        mr.reduce_sum(torch.zeros(1, device=DEV), mesh=mesh)
        torch.cuda.synchronize()

    def in_turn(fn):
        """fn() on rank 0, then on rank 1: timings on the shared card."""
        res = None
        for r in range(2):
            barrier()
            if r == rank:
                res = fn()
        barrier()
        return res

    def launched(names, expect, route="wgmma"):
        got = {n: kernels.LAUNCHES[n] for n in names}
        routes = {n: kernels.ROUTES[f"{n}/{route}"] for n in names}
        check(got == expect and routes == expect,
              f"{tag} launches {got} == {expect}, all on the {route} route")
        for n, v in got.items():
            out["launches"][n] = out["launches"].get(n, 0) + v

    check(mesh.backend == "gloo" and mesh.size == 2 and mesh.device.type == torch.device(DEV).type,
          f"{tag} a gloo world of two ranks, this one on {mesh.device}")

    # -- ring_shift of a CUDA tensor: gloo's send/recv refuses it, so it stages
    t = torch.arange(4, device=DEV, dtype=torch.float32) + 10 * rank
    got = mr.ring_shift(t, "data", [(0, 1), (1, 0)], mesh=mesh)
    check(torch.equal(got, torch.arange(4, device=DEV, dtype=torch.float32) + 10 * (1 - rank))
          and got.device.type == torch.device(DEV).type,
          f"{tag} ring_shift of a CUDA tensor (staged through the host) swaps the ranks' blocks")

    # -- PCA stream at full width: phase 3's eight batches, split 5 / 3 -----------
    mine = range(P26_SPLIT[0]) if rank == 0 else range(P26_SPLIT[0], N_BATCHES)
    if rank == 0:  # one process's fold of all eight integer batches
        ref_state = gram_ops.init_stats(D, device=DEV)
        for xb in int_batches(torch, range(N_BATCHES)):
            gram_ops.streaming_update_rows(ref_state, xb, xb.shape[0])
    state = gram_ops.init_stats(D, device=DEV)
    ints = list(int_batches(torch, mine))
    for xb in lockstep_batches(iter(ints), D):
        gram_ops.streaming_update_rows(state, xb, xb.shape[0], mesh=mesh)
    del ints
    out["digests"]["int_state"] = _state_digest(state)
    if rank == 0:
        check(all(torch.equal(a, b) for a, b in zip(state, ref_state)),
              f"{tag} small-integer rows at phase 3's shapes: the two-rank state bitwise equal "
              f"to one process's fold of all {N_BATCHES} batches")
        del ref_state
    del state
    gen, scales, mu, batches = phase3_rows(torch)
    ref64 = gram64(torch, batches) if rank == 0 else None
    mine_b = [batches[b] for b in mine]
    n_mine = sum(b.shape[0] for b in mine_b)
    del batches
    torch.cuda.synchronize()
    barrier()
    kernels.reset_launches()
    profiling.reset_span_totals()
    t0 = time.perf_counter()
    sol = pca.fit_pca_stream(iter(mine_b), k=K, n_cols=D, mesh=mesh)
    stream_s = time.perf_counter() - t0
    spans = profiling.span_totals()
    launched(["gram_colsum"], {"gram_colsum": len(mine_b)})
    out["pca_stream"] = {
        "s": stream_s,
        "collective": spans.get("collective reduce", (0.0, 0)),
        "lockstep": spans.get("lockstep gather", (0.0, 0)),
    }
    check(sol.n_rows == P3_ROWS, f"{tag} the stream's global rows {sol.n_rows} == {P3_ROWS}")
    out["digests"]["pca_stream"] = _digest(sol.pc, sol.explained_variance)
    if rank == 0:
        pc_ref, ev_ref, _ = reference_pca(*ref64, K)
        err = sign_aligned_err(sol.pc, pc_ref)
        ev_err = float((torch.as_tensor(sol.explained_variance, device=DEV) - ev_ref).abs().max())
        check(err <= 1e-3 and ev_err <= 1e-4,
              f"{tag} two-rank PCA stream (d={D}, k={K}) vs phase 3's float64 reference: pc err "
              f"{err:.3e} (tol 1e-3), explained variance err {ev_err:.3e} (tol 1e-4)")
        del ref64
    barrier()
    t0 = time.perf_counter()
    pca.fit_pca_stream(iter(mine_b), k=K, n_cols=D, mesh=mesh)
    out["pca_stream"]["s_second"] = time.perf_counter() - t0
    # The parts alone, each rank in turn: the fold kernel at a batch, and
    # the sum of one batch's (count, colsum, gram) partial over the ranks.
    xb0 = mine_b[0]
    count, colsum, g = gram_ops.init_stats(D, device=DEV)
    out["fold_ms"] = in_turn(lambda: time_ms(
        lambda: kernels.gram_colsum(xb0, xb0.shape[0], (g, colsum, count)), 5))
    part = gram_ops.init_stats(D, device=DEV)
    barrier()
    t0 = time.perf_counter()
    for _ in range(5):
        gram_ops.reduce_stats(part, mesh)
    torch.cuda.synchronize()
    out["reduce_ms"] = (time.perf_counter() - t0) / 5 * 1e3
    out["reduce_bytes"] = (D * D + D + 1) * 4
    del mine_b, g, part, xb0

    # -- in-memory fit_pca: phase 4's 1,048,576 rows, 524,288 a rank ----------------
    x32 = make_rows(gen, IN_MEMORY_ROWS, scales, mu, torch.float32)
    half = IN_MEMORY_ROWS // 2
    mine_x = x32[rank * half:(rank + 1) * half].clone()
    ref64 = gram64(torch, [x32], torch.bfloat16) if rank == 0 else None
    del x32
    torch.cuda.synchronize()
    barrier()
    kernels.reset_launches()
    t0 = time.perf_counter()
    sol = pca.fit_pca(mine_x, k=K, mesh=mesh)
    out["pca_mem_s"] = time.perf_counter() - t0
    launched(["gram"], {"gram": 1})
    out["digests"]["pca_mem"] = _digest(sol.pc)
    if rank == 0:
        pc_ref, _, gap = reference_pca(*ref64, K)
        err = sign_aligned_err(sol.pc, pc_ref)
        check(err <= 1e-3 and sol.n_rows == IN_MEMORY_ROWS,
              f"{tag} two-rank fit_pca of {IN_MEMORY_ROWS} x {D} vs float64 of the bf16-rounded "
              f"rows: pc err {err:.3e} (tol 1e-3; eigengap {gap:.3e}), {sol.n_rows} rows")
    del mine_x, ref64
    torch.cuda.empty_cache()

    # -- LinearRegression at d = 1024: phase 9's stream (5 / 3) and in-memory rows ------
    gen = torch.Generator(device=DEV).manual_seed(4)
    w = torch.randn((LR_D,), generator=gen, device=DEV) / LR_D ** 0.5
    parts = [lr_batch(torch, gen, LR_LAST_BATCH_ROWS if b == LR_BATCHES - 1 else BATCH_ROWS,
                      w, torch.bfloat16) for b in range(LR_BATCHES)]
    x32, y32 = lr_batch(torch, gen, LR_IN_MEMORY_ROWS, w, torch.float32)
    ref_s = lr_reference(torch, parts, lr) if rank == 0 else None
    ref_m = lr_reference(torch, [(x32, y32)], lr) if rank == 0 else None
    mine_p = parts[:P26_SPLIT[0]] if rank == 0 else parts[P26_SPLIT[0]:]
    half = LR_IN_MEMORY_ROWS // 2
    mx, my = x32[rank * half:(rank + 1) * half].clone(), y32[rank * half:(rank + 1) * half].clone()
    del parts, x32, y32
    torch.cuda.synchronize()
    barrier()
    kernels.reset_launches()
    t0 = time.perf_counter()
    st = lr.init_normal_eq_stats(LR_D, device=DEV)
    n_local = 0
    for xb, yb in lockstep_labeled_batches(iter(mine_p), LR_D):
        n_local += xb.shape[0]
        lr.streaming_normal_eq_update(st, xb, yb, mesh=mesh)
    n_rows = int(distributed.row_counts(n_local).sum())
    sol = lr.finalize_normal_eq_stats(st, 0.0, 0.0, True, 500, 1e-6, n_rows)
    out["linreg_stream_s"] = time.perf_counter() - t0
    launched(["linreg_stats"], {"linreg_stats": len(mine_p)})
    kernels.reset_launches()
    with config.option("compute_dtype", "float32"):
        solm = lr.fit_linear_regression(mx, my, mesh=mesh)
    launched(["linreg_stats"], {"linreg_stats": 1}, route="ffma")
    out["digests"]["linreg"] = _digest(sol.coefficients, solm.coefficients)
    if rank == 0:
        es = float(abs(sol.coefficients - ref_s.coefficients).max())
        em = float(abs(solm.coefficients - ref_m.coefficients).max())
        check(es <= 1e-4 and abs(sol.intercept - ref_s.intercept) <= 1e-4 and em <= 1e-4
              and abs(solm.intercept - ref_m.intercept) <= 1e-4,
              f"{tag} two-rank LinearRegression vs float64 normal equations: stream "
              f"coefficients err {es:.3e}, in-memory (f32) {em:.3e} (tol 1e-4, phase 9's)")
    del mine_p, mx, my, st

    # -- multinomial LogisticRegression stream: phase 12's rows, five passes -------------
    gen = torch.Generator(device=DEV).manual_seed(8)
    x = torch.randn((MN_ROWS, LG_D), generator=gen, device=DEV)
    w_true = torch.randn((LG_D, MN_CLASSES), generator=gen, device=DEV) / LG_D ** 0.5
    b_true = 0.5 * torch.randn((MN_CLASSES,), generator=gen, device=DEV)
    y = torch.multinomial(torch.softmax(x @ w_true + b_true, dim=1), 1, generator=gen)[:, 0].float()
    splits = [(x[:P26_MN_SPLIT].tensor_split(3), y[:P26_MN_SPLIT].tensor_split(3)),
              (x[P26_MN_SPLIT:].tensor_split(2), y[P26_MN_SPLIT:].tensor_split(2))]
    mine_mn = list(zip(*splits[rank]))
    barrier()
    kernels.reset_launches()
    t0 = time.perf_counter()
    sol = lg.fit_multinomial_stream(lambda: iter(mine_mn), n_cols=LG_D, n_classes=MN_CLASSES,
                                    reg=LG_REG, max_iter=MN_PASSES, tol=0.0, mesh=mesh)
    out["multinomial_s"] = time.perf_counter() - t0
    launched(["softmax_curvature"], {"softmax_curvature": MN_PASSES * len(mine_mn)})
    out["digests"]["multinomial"] = _digest(sol.coefficients, sol.intercept)
    if rank == 0:
        every = list(zip(*splits[0])) + list(zip(*splits[1]))

        def multinomial_ref(sol=sol, every=every):
            ref = lg.fit_multinomial_stream(lambda: iter(every), n_cols=LG_D,
                                            n_classes=MN_CLASSES, reg=LG_REG, max_iter=MN_PASSES,
                                            tol=0.0, device=DEV)
            scale = float(abs(ref.coefficients).max())
            err_w = float(abs(sol.coefficients - ref.coefficients).max()) / scale
            err_b = float(abs(sol.intercept - ref.intercept).max()) / scale
            check(sol.n_rows == MN_ROWS and err_w <= 3e-5 and err_b <= 1e-3,
                  f"{tag} two-rank multinomial stream (C={MN_CLASSES}, d={LG_D}, {MN_PASSES} "
                  f"passes) vs one process's stream of the same batches: W err {err_w:.3e} "
                  f"(tol 3e-5), b {err_b:.3e} (tol 1e-3) of max|W|")

        after.append(multinomial_ref)
    del x, y, splits, mine_mn
    torch.cuda.empty_cache()

    # -- exact NearestNeighbors: phase 16's rows, 524,288 a rank ---------------------------
    gen = torch.Generator(device=DEV).manual_seed(9)
    centers = torch.randn((KNN_CLUSTERS, KNN_D), generator=gen, device=DEV)
    x = knn_data(torch, gen, KNN_ROWS, centers)
    qs = knn_data(torch, gen, KNN_QUERIES, centers)
    del centers
    half = KNN_ROWS // 2
    nn = NearestNeighbors(mesh=mesh).setK(KNN_K).fit({"features": x[rank * half:(rank + 1) * half]})
    barrier()
    kernels.reset_launches()
    d_nn, i_nn = nn.kneighbors(qs)
    launched(["dist_topk"], {"dist_topk": 1})
    barrier()
    t0 = time.perf_counter()
    nn.kneighbors(qs)
    out["knn_qps"] = KNN_QUERIES / (time.perf_counter() - t0)
    out["digests"]["knn"] = _digest(d_nn, i_nn)
    if rank == 0:

        def knn_ref(x=x, qs=qs, d_nn=d_nn, i_nn=i_nn):
            cd = config.compute_dtype(DEV)
            pd, pi = (NearestNeighbors(device=DEV).setK(KNN_K).fit({"features": x})
                      .kneighbors(qs))
            scale = float(kernels.row_sq_norms(qs.to(cd)).max()) + float(
                kernels.row_sq_norms(x.to(cd)).max())
            tol = 4e-6 * scale  # phase 15's
            sq = lambda a: torch.as_tensor(a, device=DEV).double() ** 2  # noqa: E731
            check_selection(torch, f"{tag} two-rank exact kneighbors ({KNN_QUERIES} queries, "
                            f"k={KNN_K}) vs phase 16's one-process answer (tol {tol:.2e})",
                            sq(d_nn), torch.as_tensor(i_nn, device=DEV), sq(pd),
                            torch.as_tensor(pi, device=DEV), tol)

        after.append(knn_ref)
    del x, qs, nn
    torch.cuda.empty_cache()

    # -- the binomial and KMeans streams at a small depth (no kernel) ------------------
    gen = torch.Generator(device=DEV).manual_seed(26)
    n = 2 * P26_SMALL_ROWS
    xb = torch.randn((n, LG_D), generator=gen, device=DEV)
    wb = torch.randn((LG_D,), generator=gen, device=DEV) / LG_D ** 0.5
    yb = (xb @ wb + 0.3 * torch.randn((n,), generator=gen, device=DEV) > 0).float()
    parts = [list(zip(xb[r * P26_SMALL_ROWS:(r + 1) * P26_SMALL_ROWS].tensor_split(3 - r),
                      yb[r * P26_SMALL_ROWS:(r + 1) * P26_SMALL_ROWS].tensor_split(3 - r)))
             for r in range(2)]
    bsol = lg.fit_logistic_stream(lambda: iter(parts[rank]), n_cols=LG_D, reg=LG_REG, max_iter=3,
                                  tol=0.0, mesh=mesh)
    cent = KM_SCALE * torch.randn((P26_KM_K, KM_D), generator=gen, device=DEV)
    lab = torch.randint(0, P26_KM_K, (n,), generator=gen, device=DEV)
    xk = cent[lab] + KM_NOISE * torch.randn((n, KM_D), generator=gen, device=DEV)
    kparts = [xk[r * P26_SMALL_ROWS:(r + 1) * P26_SMALL_ROWS].tensor_split(3 - r) for r in range(2)]
    ksol = km.fit_kmeans_stream(lambda: iter(kparts[rank]), k=P26_KM_K, n_cols=KM_D, max_iter=5,
                                seed=0, mesh=mesh)
    out["digests"]["small"] = _digest(bsol.coefficients, ksol.centers)
    if rank == 0:

        def small_ref():
            bref = lg.fit_logistic_stream(lambda: iter(parts[0] + parts[1]), n_cols=LG_D,
                                          reg=LG_REG, max_iter=3, tol=0.0, device=DEV)
            kref = km.fit_kmeans_stream(lambda: iter(list(kparts[0]) + list(kparts[1])),
                                        k=P26_KM_K, n_cols=KM_D, max_iter=5, seed=0, device=DEV)
            eb = float(abs(bsol.coefficients - bref.coefficients).max()) / float(
                abs(bref.coefficients).max())
            ek = float(abs(ksol.centers - kref.centers).max()) / float(abs(kref.centers).max())
            # Tolerances: float32 sums of the same rows in another order
            # (about 1e-6 relative) through three Newton / five Lloyd steps.
            check(eb <= 1e-4 and ek <= 1e-5 and ksol.n_iter == kref.n_iter
                  and bsol.n_rows == kref.n_rows == n,
                  f"{tag} binomial stream (d={LG_D}, {n} rows, 3 Newton steps) vs one process: "
                  f"coefficients err {eb:.3e} of max|w| (tol 1e-4); KMeans stream (d={KM_D}, "
                  f"k={P26_KM_K}, {ksol.n_iter} Lloyd steps) vs one process: centres err "
                  f"{ek:.3e} of max|c| (tol 1e-5)")

        after.append(small_ref)
    out["staged"] = dict(mr.STAGED)
    on_card = int(torch.device(DEV).type == "cuda")  # a CPU rehearsal stages nothing
    check(out["staged"] == {"all_reduce": 0, "all_gather": 0, "send_recv": on_card},
          f"{tag} staged through the host: {out['staged']} (gloo runs the all_reduce and "
          f"all_gather of CUDA tensors itself; the ring_shift's send/recv is staged)")
    barrier()
    distributed.shutdown_cluster()
    for ref in after:  # rank 0, now a process of its own
        ref()
    return out


def _await(procs, q, n, timeout_s, what):
    """Collect n reports from spawned ranks; kill every rank and fail on an
    error, a non-zero exit or the time limit."""
    import queue

    deadline = time.perf_counter() + timeout_s
    got = {}
    while len(got) < n:
        try:
            kind, who, payload = q.get(timeout=1.0)
        except queue.Empty:
            dead = [p for p in procs if p.exitcode not in (None, 0)]
            if dead or time.perf_counter() > deadline:
                for p in procs:
                    p.kill()
                fail(f"{what}: a rank exited with {[p.exitcode for p in procs]} or passed "
                     f"its {timeout_s} s limit")
            continue
        if kind != "ok":
            for p in procs:
                p.kill()
            fail(f"{what}: rank {who} failed: {payload}")
        got[who] = payload
    for p in procs:
        p.join(timeout=60)
        if p.exitcode != 0:
            for r in procs:
                r.kill()
            fail(f"{what}: a rank exited with {p.exitcode}")
    return got


def _p26_report(res, card, stream_rate) -> dict:
    """Phase 26b's cross-rank checks and numbers from the ranks' reports;
    returns the path kernels' launches summed over the ranks."""
    for key in res[0]["digests"]:
        check(res[0]["digests"][key] == res[1]["digests"][key],
              f"26b: both ranks' {key} results bitwise identical ({res[0]['digests'][key]})")
    launches = {name: res[0]["launches"].get(name, 0) + res[1]["launches"].get(name, 0)
                for name in P26_KERNELS}
    print(f"26b: kernel launches summed over the two ranks: {launches}", flush=True)
    steps = max(P26_SPLIT)
    s = res[0]["pca_stream"]
    print(f"26b: two-rank PCA stream (d={D}, k={K}, {N_BATCHES} bf16 batches split "
          f"{P26_SPLIT[0]} / {P26_SPLIT[1]}, gloo on one card): first fit {s['s']:.3f} s = "
          f"{P3_ROWS / s['s']:.1f} rows/s, second {s['s_second']:.3f} s = "
          f"{P3_ROWS / s['s_second']:.1f} rows/s; phase 3 (one process): "
          + (f"{stream_rate:.1f} rows/s" if stream_rate else "not run") + f"  [{card}]",
          flush=True)
    for r in range(2):
        o = res[r]
        c_s, c_n = o["pca_stream"]["collective"]
        l_s, l_n = o["pca_stream"]["lockstep"]
        print(f"26b rank {r}: {P26_SPLIT[r]} own batches in {steps} lockstep steps; fold kernel "
              f"{o['fold_ms']:.3f} ms a batch (CUDA events, alone); the (count, colsum, gram) "
              f"reduce {o['reduce_ms']:.3f} ms a step for {o['reduce_bytes']} bytes (host clock, "
              f"synced, alone); in the fit the 'collective reduce' spans {c_s * 1e3:.1f} ms over "
              f"{c_n} calls ({c_s * 1e3 / steps:.2f} ms a step, the fold's device time included: "
              f"gloo waits for the stream), 'lockstep gather' {l_s * 1e3:.1f} ms over {l_n}; "
              f"in-memory fit_pca {o['pca_mem_s']:.3f} s, linreg stream "
              f"{o['linreg_stream_s']:.3f} s, multinomial stream {o['multinomial_s']:.3f} s, "
              f"exact kneighbors {o['knn_qps']:.1f} q/s; staged collectives {o['staged']}",
              flush=True)
    return launches


def phase_multiprocess(torch, card, stream_rate) -> dict:
    """Phase 26: the fits across processes on the card. Returns the path
    kernels' launches summed over the two ranks of 26b."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")  # never fork a process that holds a CUDA context
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    q = ctx.Queue()
    p = ctx.Process(target=_p26_nccl, args=(_free_port(), q))
    p.start()
    _await([p], q, 1, P26_RANK_TIMEOUT_S, "26a")
    t_a = time.perf_counter() - t_phase

    # What gloo does with a CUDA tensor's send/recv, in a pair of its own:
    # a refusal may raise, or kill the pair from gloo's own thread.
    port = _free_port()
    probe = [ctx.Process(target=_p26_probe, args=(r, port, q)) for r in range(2)]
    for p in probe:
        p.start()
    seen = {}
    deadline = time.perf_counter() + 60
    while (len(seen) < 2 and any(p.is_alive() for p in probe)
           and time.perf_counter() < deadline):
        try:
            r, verdict, detail = q.get(timeout=0.5)
            seen[r] = (verdict, detail)
        except Exception:  # noqa: BLE001 - queue.Empty: poll the pair again
            pass
    for p in probe:
        p.join(timeout=10)
        if p.is_alive():
            p.kill()
            p.join()
    print(f"26: gloo send/recv (batch_isend_irecv) of CUDA tensors, two probe processes: "
          f"reports {seen or 'none'}, exit codes {[p.exitcode for p in probe]} (negative: "
          f"killed by that signal; gloo's message, if any, is on stderr above). gloo runs "
          f"all_reduce, broadcast and all_gather of CUDA tensors itself; the port stages "
          f"send/recv through the host", flush=True)

    t_b0 = time.perf_counter()
    port = _free_port()
    procs = [ctx.Process(target=_p26_rank, args=(r, port, q)) for r in range(2)]
    for p in procs:
        p.start()
    res = _await(procs, q, 2, P26_RANK_TIMEOUT_S, "26b")
    t_b = time.perf_counter() - t_b0
    launches = _p26_report(res, card, stream_rate)
    print(f"26: phase seconds {time.perf_counter() - t_phase:.1f} (26a {t_a:.1f}, 26b {t_b:.1f})",
          flush=True)
    return launches


# -- 27. the fits across daemons ------------------------------------------------

P27_SEED = 27
#: Phase 27's (and phase 28's) PCA frames: 32,768 rows, 524,288 a fit (cut
#: from 65,536 and 1,048,576 for the smoke's time; the frame and feed
#: counts, and with them every launch and fault count, are unchanged).
P27_PCA_ROWS = DP_ROWS // 2
#: Phase 27: run → the P21_RUNS fields (a forest run adds its dataset's
#: rows: phase 25's HIGGS cut from 11,000,000 to 1,048,576). The "-int" runs
#: draw their rows from {-1, 0, 1}. The task processes get it as an argument.
P27_RUNS = {
    "pca-int": ("pca", D, P27_PCA_ROWS, DP_FEEDS, K),
    "pca": ("pca", D, P27_PCA_ROWS, DP_FEEDS, K),
    "linreg-int": ("linreg", LR_D, DP_ROWS, 2, 0),
    "logreg-multinomial": ("logreg", LG_D, 16384, 1, MN_CLASSES),
    "kmeans": ("kmeans", KM_D, DP_ROWS, 2, KM_K),
    "higgs": ("rf", HIGGS_D, DP_ROWS, 2, 2, 1 << 20),
    "knn": ("knn", KNN_D, DP_ROWS, DP_FEEDS, KNN_CLUSTERS),
}
#: The partitions whose executors feed the second daemon.
P27_PEER_PARTS = tuple(range(DP_PARTITIONS // 2, DP_PARTITIONS))
#: The kernels on phase 27's path: each must launch in its two-daemon fits
#: and served calls.
P27_KERNELS = ("gram_colsum", "linreg_stats", "softmax_curvature", "lloyd_step",
               "assign_min_dist", "dist_topk", "probe_select", "ivf_scan_select")
P27_DAEMON_TIMEOUT_S = 300  # a spawned daemon process's time to come up


def p27_rows(run) -> int:
    if run == "higgs":
        return P27_RUNS[run][5]
    _, _, rows, frames, _ = P27_RUNS[run]
    return DP_PARTITIONS * frames * rows


def p27_fit(torch, kernels, est, profiling, pool, primary, run, drive, tag, route=None,
            addresses=None, hub=False, other_process=False):
    """One phase-27 fit: the estimator's driver function ``drive(fit,
    run_pass)`` with the daemon at ``primary`` as the fit's primary, the
    pool's partitions in ``route`` fed to their own daemon (partition
    SPARK_DYING's attempt 0 dies after a feed in the first scan),
    ``addresses`` the configured daemons (``SRML_DAEMON_ADDRESSES``, which
    ``daemon_session.resolve_all`` reads: the kmeans and forest seeds) and
    ``hub`` forcing the driver's hub (``mesh_collectives`` off). The kernel
    counters and spans are reset just before the fit and read just after.
    Checks the rows and which reduce path ran (the hub for a peer in
    ``other_process``). Returns (model, a record of the run)."""
    from spark_rapids_ml_tpu_torch import config

    job = f"phase27-{run}-{tag}"
    fit = est._DaemonFit(*primary, job)
    rec = {"scans": 0}
    if run != "knn":
        real = fit.finalize_guarded

        def guarded(params, pass_rows_expected=None):
            rec["status"] = fit.client.status(job)["rows"]
            arrays, rows = real(params, pass_rows_expected)
            rec["finalize"] = rows
            return arrays, rows

        fit.finalize_guarded = guarded

    def run_pass(pass_id):
        rec["scans"] += 1
        return pool.scan(run, job, fit.params, pass_id, dies=rec["scans"] == 1, route=route)

    paths = est._M_MESH_PATHS
    before = {p: paths.value(path=p) for p in ("collective", "hub")}
    if addresses:
        os.environ["SRML_DAEMON_ADDRESSES"] = ",".join("%s:%d" % tuple(a) for a in addresses)
    try:
        torch.cuda.synchronize()
        kernels.reset_launches()
        profiling.reset_span_totals()
        with config.option("mesh_collectives", not hub):
            t0 = time.perf_counter()
            model = drive(fit, run_pass)
            torch.cuda.synchronize()
            rec["s"] = time.perf_counter() - t0
        rec["launches"], rec["routes"] = dict(kernels.LAUNCHES), dict(kernels.ROUTES)
        rec["spans"] = profiling.span_totals()
    finally:
        os.environ.pop("SRML_DAEMON_ADDRESSES", None)
        fit.close()
    rec["paths"] = {p: paths.value(path=p) - before[p] for p in before}
    n = p27_rows(run)
    rec["rows"], rec["acked"], rec["peers"] = n, fit.total_fed, len(fit.peers)
    if run != "knn":
        check(rec["acked"] == rec["status"] == rec["finalize"] == n * rec["scans"],
              f"phase 27 {run} {tag}: acked {rec['acked']}, primary status {rec['status']}, "
              f"finalize {rec['finalize']} rows == {rec['scans']} scans x {n} (the peer's "
              f"rows folded into the primary, the dying attempt's counted nowhere)")
    reduces = 0 if route is None or run == "knn" else rec["scans"]
    path = "hub" if hub or other_process else "collective"
    want = {"collective": 0, "hub": 0, path: reduces}
    check(rec["peers"] == (0 if route is None else 1) and rec["paths"] == want,
          f"phase 27 {run} {tag}: {rec['peers']} peer daemon(s), reduce paths {rec['paths']} "
          f"== {want} (one reduce a scan)")
    frame_gib = rec["scans"] * n * (P27_RUNS[run][1] + 1) * 4 / 2 ** 30
    print(f"phase 27 {run} {tag}: {n} rows x {P27_RUNS[run][1]}, {rec['scans']} scans in "
          f"{rec['s']:.3f} s: {n * rec['scans'] / rec['s']:.1f} rows/s through the daemons, "
          f"{frame_gib / rec['s']:.2f} GiB/s of frames (host clock)", flush=True)
    return model, rec


def p27_reduce_cost(rec, tag, state_bytes) -> str:
    """One pass's reduce on the path ``rec`` ran: the driver's and the
    primary daemon's host-clock ms a scan and the bytes moved."""
    spans, scans = rec["spans"], rec["scans"]

    def ms(name):
        return 1e3 * spans.get(name, (0.0, 0))[0] / scans

    merge = ms("daemon merge")
    if rec["paths"]["collective"]:
        return (f"{tag}: reduce_mesh {ms('reduce mesh'):.3f} ms a pass (the daemon's device add "
                f"{merge:.3f} ms), 0 wire bytes, {3 * state_bytes} device bytes (two states "
                f"read, one written)")
    return (f"{tag}: export_state {ms('export state'):.3f} ms + merge_state "
            f"{ms('merge state'):.3f} ms a pass (the primary's add "
            f"{'not in this process' if not merge else f'{merge:.3f} ms'}), "
            f"{2 * state_bytes} wire bytes (the state out of the peer, then into the primary)")


def p27_same(np, pairs, tag) -> None:
    """Each (name, got, want) array pair bitwise equal."""
    for name, g, w in pairs:
        g, w = np.asarray(g), np.asarray(w)
        same = g.shape == w.shape and g.dtype == w.dtype and np.array_equal(g, w)
        diff = float(np.abs(g.astype(np.float64) - w.astype(np.float64)).max()) \
            if g.shape == w.shape else float("nan")
        check(same, f"{tag}: {name} bitwise equal (max diff {diff:.3e})")


def p27_attrs(model, ref, attrs):
    return [(a, getattr(model, a), getattr(ref, a)) for a in attrs]


def _p27_daemon(out, stop, device):
    """Phase 27b's daemon process: one port daemon on ``device`` (the card),
    as on an executor host of its own. Reports its port, serves until
    ``stop``, then reports its kernel launches."""
    try:
        from spark_rapids_ml_tpu_torch.ops import kernels
        from spark_rapids_ml_tpu_torch.serve import DataPlaneDaemon

        daemon = DataPlaneDaemon(host="127.0.0.1", port=0, device=device).start()
    except Exception as e:  # noqa: BLE001 - reported to the parent
        out.put(("err", repr(e)))
        return
    out.put(("ready", daemon.address[1]))
    stop.wait()
    daemon.stop()
    out.put(("launches", dict(kernels.LAUNCHES)))


def phase_multidaemon(torch, kernels, config):
    """Phase 27: the fits across daemons. Returns {kernel: launches} of the
    two-daemon fits and served calls of part a."""
    import multiprocessing as mp
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from spark_rapids_ml_tpu_torch import (
        PCA,
        ApproximateNearestNeighbors,
        KMeans,
        LinearRegression,
        LogisticRegression,
        NearestNeighbors,
        RandomForestClassifier,
    )
    from spark_rapids_ml_tpu_torch.serve import DataPlaneDaemon
    from spark_rapids_ml_tpu_torch.spark import estimator as est
    from spark_rapids_ml_tpu_torch.utils import profiling

    t_phase = time.perf_counter()
    print(f"phase 27: the fits across daemons, {DP_PARTITIONS} task processes (forked, reused) x "
          f"feed_raw frames of {DP_ROWS} rows (PCA's {P27_PCA_ROWS}); partitions "
          f"{P27_PEER_PARTS[0]}-"
          f"{P27_PEER_PARTS[-1]} feed the second daemon, partition {SPARK_DYING}'s attempt 0 "
          f"dies after one feed in each fit's first scan", flush=True)
    out = {k: 0 for k in P27_KERNELS}

    def count(launches):
        for k in P27_KERNELS:
            out[k] += launches.get(k, 0)

    def rate(rec):
        return rec["rows"] * rec["scans"] / rec["s"]

    def beside(key):
        r = ONE_DAEMON_RATES.get(key)
        return f"{key} {'not run' if r is None else f'{r:.1f}'}"

    pca_bytes = 4 * (1 + D + D * D)
    with DataPlaneDaemon(host="127.0.0.1", port=0, device=DEV) as a, \
            DataPlaneDaemon(host="127.0.0.1", port=0, device=DEV) as b:
        t_spawn = time.perf_counter()
        pool = _P21Pool(a.address, P27_RUNS)
        print(f"phase 27 tasks ready (forked, imported the port) in "
              f"{time.perf_counter() - t_spawn:.1f} s", flush=True)
        route = {p: b.address for p in P27_PEER_PARTS}
        both = [a.address, b.address]
        try:
            def fit(run, drive, tag, **kw):
                return p27_fit(torch, kernels, est, profiling, pool, a.address, run, drive, tag,
                               **kw)

            # -- a. PCA on {-1, 0, 1} rows: one daemon, the collective, the hub --
            pool.prepare("pca-int")
            pca_core = PCA(device=DEV).setK(K)

            def drive_pca(f, rp):
                return est._drive_pca(f, rp, pca_core)

            pca_one, r_one = fit("pca-int", drive_pca, "one daemon")
            P27_ORACLE.update(model=pca_one, s=r_one["s"])
            pca_coll, r_coll = fit("pca-int", drive_pca, "collective", route=route)
            pca_hub, r_hub = fit("pca-int", drive_pca, "hub", route=route, hub=True)
            folded = DP_PARTITIONS * DP_FEEDS + 1  # every frame and the dying attempt's one
            for tag, r in (("one daemon", r_one), ("collective", r_coll), ("hub", r_hub)):
                check(r["launches"]["gram_colsum"] == folded
                      and r["routes"]["gram_colsum/wgmma"] == folded
                      and sum(r["launches"].values()) == folded,
                      f"phase 27 pca-int {tag}: gram_colsum launches "
                      f"{r['launches']['gram_colsum']} == folded feeds {folded} over both "
                      f"daemons, all wgmma, no other kernel")
            count(r_coll["launches"])
            count(r_hub["launches"])
            attrs = ("pc", "explainedVariance", "mean")
            p27_same(np, p27_attrs(pca_coll, pca_one, attrs),
                     "phase 27 pca-int: two daemons (collective) vs one daemon")
            p27_same(np, p27_attrs(pca_hub, pca_coll, attrs),
                     "phase 27 pca-int: the hub vs the collective")
            print(f"phase 27 pca-int reduce per pass (d = {D}, a state of "
                  f"{pca_bytes} bytes): " + p27_reduce_cost(r_coll, "collective", pca_bytes)
                  + "; " + p27_reduce_cost(r_hub, "hub", pca_bytes), flush=True)

            # -- PCA on phase 20's gaussian rows, two daemons: held to float64 ---
            pool.prepare("pca")
            pca_g, r_g = fit("pca", drive_pca, "collective", route=route)
            count(r_g["launches"])
            check(r_g["launches"]["gram_colsum"] == folded,
                  f"phase 27 pca: gram_colsum launches {r_g['launches']['gram_colsum']} == "
                  f"{folded}")
            n_rows = p27_rows("pca")
            count64 = torch.tensor(float(n_rows), dtype=torch.float64, device=DEV)
            colsum = torch.zeros(D, dtype=torch.float64, device=DEV)
            gram = torch.zeros((D, D), dtype=torch.float64, device=DEV)
            keys = [(p, f) for p in range(DP_PARTITIONS) for f in range(DP_FEEDS)]
            with ThreadPoolExecutor(max_workers=8) as ex:
                for x in ex.map(lambda pf: spark_rows(np, pf[0], pf[1], P27_PCA_ROWS, D, K),
                                keys):
                    xd = torch.from_numpy(x).to(DEV).double()
                    gram.addmm_(xd.T, xd)
                    colsum.add_(xd.sum(0))
                    del xd
            pc_ref, ev_ref, gap = reference_pca(count64, colsum, gram, K)
            del gram, colsum
            err = sign_aligned_err(pca_g.pc, pc_ref)
            ev_err = float((torch.as_tensor(pca_g.explainedVariance, device=DEV)
                            - ev_ref).abs().max())
            check(err <= 1e-3 and ev_err <= 1e-4,
                  f"phase 27 pca (gaussian, two daemons) vs float64 of the same rows: max "
                  f"sign-aligned err {err:.3e} (tol 1e-3; eigengap {gap:.3e}), σ/Σσ {ev_err:.3e} "
                  f"(tol 1e-4) (phase 20's tolerances)")
            print(f"phase 27 rows/s: pca-int one daemon {rate(r_one):.1f}, collective "
                  f"{rate(r_coll):.1f}, hub {rate(r_hub):.1f}, pca (gaussian) collective "
                  f"{rate(r_g):.1f}; {beside('phase 20 pca')}", flush=True)

            # -- LinearRegression on {-1, 0, 1} rows: one daemon, two -------------
            pool.prepare("linreg-int")
            lr_core = LinearRegression(device=DEV)

            def drive_lr(f, rp):
                return est._drive_linreg(f, rp, lr_core)

            lr_one, r1 = fit("linreg-int", drive_lr, "one daemon")
            lr_two, r2 = fit("linreg-int", drive_lr, "collective", route=route)
            folded = 2 * DP_PARTITIONS + 1
            check(r2["launches"]["linreg_stats"] == folded
                  and r2["routes"]["linreg_stats/wgmma"] == folded,
                  f"phase 27 linreg-int: linreg_stats launches {r2['launches']['linreg_stats']} "
                  f"== folded feeds {folded}, all wgmma")
            count(r2["launches"])
            p27_same(np, p27_attrs(lr_two, lr_one, ("coefficients", "intercept")),
                     "phase 27 linreg-int: two daemons vs one daemon")
            check(lr_two.summary.rmse == lr_one.summary.rmse
                  and lr_two.summary.r2 == lr_one.summary.r2,
                  f"phase 27 linreg-int: rmse {lr_two.summary.rmse!r} and r2 "
                  f"{lr_two.summary.r2!r} equal to one daemon's")
            print(f"phase 27 rows/s: linreg-int one daemon {rate(r1):.1f}, two daemons "
                  f"{rate(r2):.1f}; {beside('phase 21 linreg')}", flush=True)

            # -- multinomial LogisticRegression: one daemon, two ------------------
            pool.prepare("logreg-multinomial")
            mn_core = (LogisticRegression(device=DEV).setRegParam(LG_REG).setMaxIter(P21_PASSES)
                       .setTol(0.0))

            def drive_mn(f, rp):
                return est._drive_logreg(f, rp, mn_core, MN_CLASSES)

            mn_one, r1 = fit("logreg-multinomial", drive_mn, "one daemon")
            mn_two, r2 = fit("logreg-multinomial", drive_mn, "collective", route=route)
            folded = DP_PARTITIONS * r2["scans"] + 1
            check(r1["scans"] == r2["scans"] == P21_PASSES
                  and r2["launches"]["softmax_curvature"] == folded
                  and r2["routes"]["softmax_curvature/wgmma"] == folded,
                  f"phase 27 multinomial: {r1['scans']} and {r2['scans']} passes == "
                  f"{P21_PASSES}; softmax_curvature launches "
                  f"{r2['launches']['softmax_curvature']} == folded feeds {folded}, all wgmma")
            count(r2["launches"])
            scale = float(np.abs(mn_one.coefficients).max())
            err_w = float(np.abs(mn_two.coefficients - mn_one.coefficients).max()) / scale
            err_b = float(np.abs(mn_two.intercept - mn_one.intercept).max()) / scale
            # Tolerance: phase 21's (3e-5 and 1e-3 of max|W|): the same f32
            # statistics summed in another order through five MM steps.
            check(err_w <= 3e-5 and err_b <= 1e-3,
                  f"phase 27 multinomial: two daemons vs one daemon, max err W {err_w:.3e} (tol "
                  f"3e-5), b {err_b:.3e} (tol 1e-3) of max|W| {scale:.4f}")
            print(f"phase 27 rows/s: multinomial one daemon {rate(r1):.1f}, two daemons "
                  f"{rate(r2):.1f}; {beside('phase 21 logreg-multinomial')}", flush=True)

            # -- KMeans: both daemons seeded through resolve_all ------------------
            pool.prepare("kmeans")
            km_sample = p21_frame(np, P27_RUNS, "kmeans", 0, 0)[0][:est._kmeans_seed_rows(KM_K)]
            km_core = (KMeans(device=DEV).setK(KM_K).setMaxIter(KM_MAX_ITER).setTol(KM_TOL)
                       .setSeed(P27_SEED))

            def drive_km(f, rp):
                return est._drive_kmeans(f, rp, km_core, km_sample)

            km_one, r1 = fit("kmeans", drive_km, "one daemon")
            km_two, r2 = fit("kmeans", drive_km, "collective", route=route, addresses=both)
            check(sum(r2["launches"].values()) == 0
                  and km_two.summary.numIter == km_one.summary.numIter
                  and r2["scans"] == km_two.summary.numIter + 1,
                  f"phase 27 kmeans: {km_two.summary.numIter} Lloyd passes as one daemon's "
                  f"{km_one.summary.numIter}, and the cost scan; no kernel (the reference's "
                  f"daemon folds kmeans without one)")
            err_c = float(np.abs(km_two.centers - km_one.centers).max())
            cost = abs(km_two.summary.trainingCost - km_one.summary.trainingCost) \
                / km_one.summary.trainingCost
            # Tolerance: phase 21's (1e-6 of the centres and the cost): the same
            # f32 sums of the same rows in another order.
            check(err_c <= 1e-6 and cost <= 1e-6,
                  f"phase 27 kmeans: two daemons vs one daemon, centres max err {err_c:.3e}, "
                  f"cost rel err {cost:.3e} (tol 1e-6 each)")
            print(f"phase 27 rows/s: kmeans one daemon {rate(r1):.1f}, two daemons "
                  f"{rate(r2):.1f}; {beside('phase 21 kmeans')}", flush=True)

            # -- the HIGGS-shape forest: both daemons seeded through resolve_all --
            pool.prepare("higgs")
            rf_sample = rf_frame(np, P27_RUNS, "higgs", 0, 0)[0]  # the prefix of partition 0
            rf_core = RandomForestClassifier(device=DEV).setSeed(RF_SEED)

            def drive_rf(f, rp):
                return est._drive_forest(f, rp, rf_core, rf_sample, 2)

            rf_one, r1 = fit("higgs", drive_rf, "one daemon")
            rf_two, r2 = fit("higgs", drive_rf, "collective", route=route, addresses=both)
            check(sum(r2["launches"].values()) == 0 and r1["scans"] == r2["scans"],
                  f"phase 27 higgs forest: {r2['scans']} passes as one daemon's {r1['scans']}, "
                  f"no hand-written kernel")
            check(sorted(rf_two.arrays) == sorted(rf_one.arrays),
                  "phase 27 higgs forest: the same tables")
            p27_same(np, [(k, rf_two.arrays[k], rf_one.arrays[k]) for k in sorted(rf_one.arrays)],
                     "phase 27 higgs forest: two daemons vs one daemon")
            print(f"phase 27 rows/s: higgs forest one daemon {rate(r1):.1f}, two daemons "
                  f"{rate(r2):.1f} ({r2['scans']} passes)", flush=True)

            # -- exact and IVF knn: one daemon, two shards ------------------------
            pool.prepare("knn")
            n_rows = p27_rows("knn")
            rows = np.empty((n_rows, KNN_D), np.float32)  # partition-major
            knn_keys = [(p, f) for p in range(DP_PARTITIONS) for f in range(DP_FEEDS)]

            def fill(i):
                rows[i * DP_ROWS:(i + 1) * DP_ROWS] = knn_frame(np, *knn_keys[i], DP_ROWS,
                                                                KNN_D, KNN_CLUSTERS)

            with ThreadPoolExecutor(max_workers=8) as ex:
                list(ex.map(fill, range(len(knn_keys))))
            qs = knn_frame(np, DP_PARTITIONS, 0, KNN_QUERIES, KNN_D, KNN_CLUSTERS)
            x_dev, q_dev = torch.from_numpy(rows).to(DEV), torch.from_numpy(qs).to(DEV)
            del rows

            def served(model, counted):
                torch.cuda.synchronize()
                kernels.reset_launches()
                model.kneighbors(qs)  # the index upload
                t0 = time.perf_counter()
                dd, ii = model.kneighbors(qs)
                s = time.perf_counter() - t0
                if counted:
                    count(kernels.LAUNCHES)
                return dd, ii, KNN_QUERIES / s, dict(kernels.LAUNCHES)

            def build_s(rec):
                return "phase 22's" if rec is None else \
                    f"{rec['spans'].get('knn build', (0.0, 0))[0]:.3f} s"

            def drive_knn(core):
                return lambda f, rp: est._drive_knn(f, rp, core)

            # The one-daemon answers: phase 22's, from the same rows and
            # queries, when it ran in this call; else a one-daemon fit here.
            exact = drive_knn(NearestNeighbors(device=DEV).setK(KNN_K))
            if "exact_answer" in P22_SERVED:
                d1, i1 = P22_SERVED["exact_answer"]
                r1, qps1 = None, P22_SERVED["exact"][1]
            else:
                nn_one, r1 = fit("knn", exact, "exact one daemon")
                d1, i1, qps1, _ = served(nn_one, False)
                nn_one.release()
            nn_two, r2 = fit("knn", exact, "exact two shards", route=route)
            want_shards = [("%s:%d" % a.address, n_rows // 2), ("%s:%d" % b.address, n_rows // 2)]
            check(nn_two.shards == want_shards and nn_two.numRows == n_rows
                  and sum(r2["launches"].values()) == 0,
                  f"phase 27 exact knn: shards {nn_two.shards} == {want_shards}, no kernel at "
                  f"the build")
            d2, i2, qps2, launches = served(nn_two, True)
            check(launches["dist_topk"] == 4 and sum(launches.values()) == 4,
                  f"phase 27 exact knn served: dist_topk launches {launches['dist_topk']} == 2 "
                  f"calls x 2 shards, no other kernel")
            # Tolerance: phase 16's, 4e-6 of the largest ‖q‖² + ‖r‖² of the
            # rounded rows; ids must equal one daemon's wherever the gap to the
            # next distance exceeds it.
            cd = config.compute_dtype(DEV)
            xr, qr = x_dev.to(cd), q_dev.to(cd)
            tol = 4e-6 * (float(kernels.row_sq_norms(qr).max())
                          + float(kernels.row_sq_norms(xr).max()))
            del xr, qr
            check_selection(torch, f"phase 27 exact knn: two shards vs one daemon (tol "
                            f"{tol:.2e})", torch.as_tensor(d2, device=DEV) ** 2,
                            torch.as_tensor(i2, device=DEV), torch.as_tensor(d1, device=DEV) ** 2,
                            torch.as_tensor(i1, device=DEV), tol)
            check(nn_two.release() and not a._models and not b._models,
                  "phase 27 exact knn: every shard released")
            p22 = P22_SERVED.get("exact")
            print(f"phase 27 exact knn: build {build_s(r1)} one daemon, {build_s(r2)} two "
                  f"shards; served q/s one daemon {qps1:.1f}, two shards {qps2:.1f}; phase 22 "
                  f"{'not run' if p22 is None else f'build {p22[0]:.3f} s, {p22[1]:.1f} q/s'}",
                  flush=True)

            ivf = drive_knn(ApproximateNearestNeighbors(device=DEV).setK(KNN_K)
                            .setNlist(KNN_NLIST).setNprobe(KNN_NPROBE))
            gt_d, gt_i = brute_force64(torch, x_dev, q_dev, KNN_K)
            del x_dev, q_dev
            if "ivf_recall" in P22_SERVED:
                r1, qps1, recall1 = None, P22_SERVED["ivf"][1], P22_SERVED["ivf_recall"]
            else:
                ann_one, r1 = fit("knn", ivf, "ivf one daemon")
                _, ia1, qps1, _ = served(ann_one, False)
                recall1 = recall_at(ia1, gt_i)
                ann_one.release()
            ann_two, r2 = fit("knn", ivf, "ivf two shards", route=route)
            lb = r2["launches"]
            check(ann_two.shards == want_shards and lb["lloyd_step"] >= 1
                  and lb["assign_min_dist"] >= 2 and lb["dist_topk"] >= 1,
                  f"phase 27 ivf: shards {ann_two.shards}; the build's launches: lloyd_step "
                  f"{lb['lloyd_step']} (the owner's quantizer), assign_min_dist "
                  f"{lb['assign_min_dist']} (both shards' assignment), dist_topk "
                  f"{lb['dist_topk']} (spill candidates)")
            count(lb)
            name = ann_two.daemon_model_name
            cent = [d._lookup_model(name).model.index.centroids for d in (a, b)]
            check(bool(torch.equal(torch.as_tensor(cent[0]), torch.as_tensor(cent[1]))),
                  "phase 27 ivf: both shards bucket against one quantizer (centroids bitwise "
                  "equal)")
            _, ia2, qps2, launches = served(ann_two, True)
            check(launches["probe_select"] == 4 and launches["ivf_scan_select"] == 4,
                  f"phase 27 ivf served: probe_select {launches['probe_select']} and "
                  f"ivf_scan_select {launches['ivf_scan_select']} == 2 calls x 2 shards")
            recall2 = recall_at(ia2, gt_i)
            check(abs(recall2 - recall1) <= 0.02,
                  f"phase 27 ivf recall@{KNN_K} (nprobe {KNN_NPROBE}) vs float64: two shards "
                  f"{recall2:.4f}, one daemon {recall1:.4f} (within 0.02)")
            for d in (a, b):
                d._lookup_model(name).model._set(nprobe=KNN_NLIST)
            _, ia_all = ann_two.kneighbors(qs)
            recall_all = recall_at(ia_all, gt_i)
            check(recall_all >= 0.98, f"phase 27 ivf two shards, every list probed (nprobe "
                                      f"{KNN_NLIST}): recall@{KNN_K} {recall_all:.4f} >= 0.98")
            check(ann_two.release() and not a._models and not b._models,
                  "phase 27 ivf: every shard released")
            p22 = P22_SERVED.get("ivf")
            print(f"phase 27 ivf: build {build_s(r1)} one daemon, {build_s(r2)} two shards (the "
                  f"cross-daemon sample, the owner's quantizer, then the other shard); served "
                  f"q/s one daemon {qps1:.1f}, two shards {qps2:.1f}; phase 22 "
                  f"{'not run' if p22 is None else f'build {p22[0]:.3f} s, {p22[1]:.1f} q/s'}",
                  flush=True)
            del gt_d, gt_i
            torch.cuda.empty_cache()
            missing = [k for k in P27_KERNELS if out[k] == 0]
            check(not missing, f"phase 27a: every kernel of the path launched in the two-daemon "
                               f"fits and served calls: {out}")

            # -- b. two daemon processes on the one card: the hub across processes -
            ctx = mp.get_context("spawn")  # never fork a process that holds a CUDA context
            qd, stop = ctx.Queue(), ctx.Event()
            procs = [ctx.Process(target=_p27_daemon, args=(qd, stop, DEV), daemon=True)
                     for _ in range(2)]
            t_spawn = time.perf_counter()
            for proc in procs:
                proc.start()
            try:
                msgs = [qd.get(timeout=P27_DAEMON_TIMEOUT_S) for _ in procs]
                bad = [m for m in msgs if m[0] != "ready"]
                check(not bad, f"phase 27b: both daemon processes up: {msgs}")
                pa, pb = (("127.0.0.1", m[1]) for m in msgs)
                print(f"phase 27b: two daemon processes on the card up in "
                      f"{time.perf_counter() - t_spawn:.1f} s", flush=True)
                pool.prepare("pca-int")
                route_b = {p: (pb if p in P27_PEER_PARTS else pa) for p in range(DP_PARTITIONS)}
                pca_p, r_p = p27_fit(torch, kernels, est, profiling, pool, pa, "pca-int",
                                     drive_pca, "two processes", route=route_b,
                                     other_process=True)
                p27_same(np, p27_attrs(pca_p, pca_one, attrs),
                         "phase 27b pca-int: two daemon processes vs one daemon")
                stop.set()
                msgs = [qd.get(timeout=60) for _ in procs]
                folded = DP_PARTITIONS * DP_FEEDS + 1
                per = [m[1].get("gram_colsum", 0) for m in msgs if m[0] == "launches"]
                check(len(per) == 2 and sum(per) == folded,
                      f"phase 27b: gram_colsum launches in the daemon processes {per} sum to "
                      f"the folded feeds {folded}")
                print("phase 27b pca-int reduce per pass: "
                      + p27_reduce_cost(r_p, "hub across processes", pca_bytes), flush=True)
                print(f"phase 27 rows/s, pca-int: two daemon processes {rate(r_p):.1f}, two "
                      f"daemons in this process {rate(r_coll):.1f}, one daemon {rate(r_one):.1f}; "
                      f"{beside('phase 20 pca')}", flush=True)
            finally:
                stop.set()
                for proc in procs:
                    proc.join(timeout=30)
                    if proc.is_alive():
                        proc.terminate()
                        proc.join(timeout=10)
        finally:
            pool.close()
    torch.cuda.empty_cache()
    print(f"phase 27: {time.perf_counter() - t_phase:.1f} s; multidaemon_launches {out}",
          flush=True)
    return out


# -- 28. the elastic fits across daemons ---------------------------------------

P28_SEED = 28
#: Phase 28: run → the P21_RUNS fields. "pca-int" is phase 27's run (its
#: {-1, 0, 1} rows); "kmeans-int" integer blobs (centres multiples of 4 in
#: [-48, 48], noise in {-1, 0, 1}), one frame a partition: 524,288 rows.
P28_RUNS = {
    "pca-int": P27_RUNS["pca-int"],
    "kmeans-int": ("kmeans", KM_D, DP_ROWS, 1, KM_K),
}
P28_MAX_ITER = 3
P28_DEATH_S = 2.0  # every phase-28 fit's death timeout
P28_MOVED = (4, 5)  # the partitions that feed the doomed peer, or the joiner
P28_SURVIVOR = (6, 7)  # the partitions that feed the surviving peer
#: Phase 28e's plan, in SRML_TORCH_FAULT_PLAN of its task processes (the
#: client sites) and active in this process (the daemon's). Every task draws
#: the same sequence from the seed (a task's ops and frames do not depend on
#: the widths), and this seed makes each task drop two ops and cut one frame:
#: the check that the healing ran cannot pass on a plan that never fires.
P28_CHAOS = ("seed=55;client.op:drop:p=0.05;wire.send_frame:partial:p=0.02;"
             "daemon.op:latency:p=0.25,delay_s=0.002")
#: The elastic counters a phase-28 fit reports, by short name.
P28_COUNTERS = ("losses", "reroutes", "joins", "rebalanced", "recoveries")


def p28_fit(torch, kernels, est, profiling, pool, primary, run, drive, tag, route=None,
            addresses=None, hub=False, plan=None, after_scan=None, **fit_kw):
    """One phase-28 fit: the estimator's driver function ``drive(fit,
    run_pass)`` over ``primary``, the pool's partitions in ``route`` fed to
    their daemons (a list: one an attempt, the next on a failed one),
    ``addresses`` the configured daemons (``SRML_DAEMON_ADDRESSES``, which
    the seed and the grow policy read), ``hub`` forcing the driver's hub,
    ``plan`` the port's FaultPlan active in this process during the fit,
    ``fit_kw`` the elastic policy and client settings of ``_DaemonFit``,
    ``after_scan(n)`` run once the n-th scan's acks are in. The counters and
    spans reset just before the fit and are read just after. Returns
    (model, a record of the run)."""
    import contextlib

    from spark_rapids_ml_tpu_torch import config
    from spark_rapids_ml_tpu_torch.utils import faults

    job = f"phase28-{run}-{tag}"
    fit = est._DaemonFit(*primary, job, **fit_kw)
    rec = {"scans": 0, "starts": []}

    def run_pass(pass_id):
        rec["scans"] += 1
        rec["starts"].append(time.perf_counter())
        acks = pool.scan(run, job, fit.params, pass_id, dies=False, route=route)
        if after_scan is not None:
            after_scan(rec["scans"])
        return acks

    counters = {"losses": est._M_DAEMON_LOSSES, "reroutes": est._M_FIT_REROUTES,
                "joins": est._M_FIT_JOINS, "rebalanced": est._M_FIT_REBALANCED,
                "recoveries": est._M_FIT_RECOVERIES}

    def totals():
        return {k: sum(v for _, v in c._samples()) for k, c in counters.items()}

    before = totals()
    if addresses:
        os.environ["SRML_DAEMON_ADDRESSES"] = ",".join("%s:%d" % tuple(a) for a in addresses)
    try:
        torch.cuda.synchronize()
        kernels.reset_launches()
        profiling.reset_span_totals()
        with config.option("mesh_collectives", not hub), \
                (faults.active(plan) if plan is not None else contextlib.nullcontext()):
            t0 = time.perf_counter()
            model = drive(fit, run_pass)
            torch.cuda.synchronize()
            rec["s"] = time.perf_counter() - t0
        rec["launches"], rec["routes"] = dict(kernels.LAUNCHES), dict(kernels.ROUTES)
        rec["spans"] = profiling.span_totals()
    finally:
        os.environ.pop("SRML_DAEMON_ADDRESSES", None)
        fit.close()
    after = totals()
    rec["counters"] = {k: int(after[k] - before[k]) for k in P28_COUNTERS}
    rec["acked"], rec["acks"] = fit.total_fed, fit.last_acks
    return model, rec


def p28_report(rec, tag, oracle_s, death=None) -> None:
    """A part's seconds, its oracle's, the seconds from the death to the
    start of the next scan (the replay), and the elastic counters."""
    replay = "no death"
    if death is not None:
        nxt = [t for t in rec["starts"] if t > death]
        replay = f"{nxt[0] - death:.3f} s" if nxt else "no scan after the death"
    spans = rec["spans"]
    el = ", ".join(f"{nm} {spans[nm][0]:.3f} s" for nm in ("elastic degrade", "elastic grow",
                                                           "recovery") if nm in spans)
    print(f"phase {tag}: {rec['s']:.3f} s in {rec['scans']} scans (oracle {oracle_s:.3f} s); "
          f"death to replay {replay}; {el or 'no elastic span'}; counters {rec['counters']}",
          flush=True)


def phase_elastic(torch, kernels, config):
    """Phase 28: the elastic fits across daemons on the card. Returns the
    gram_colsum launches of its elastic fits (28a, 28d's in this process,
    28e)."""
    import multiprocessing as mp

    import numpy as np

    from spark_rapids_ml_tpu_torch import PCA, KMeans
    from spark_rapids_ml_tpu_torch.serve import DataPlaneDaemon
    from spark_rapids_ml_tpu_torch.spark import estimator as est
    from spark_rapids_ml_tpu_torch.utils import faults, profiling

    FaultPlan = faults.FaultPlan
    t_phase = time.perf_counter()
    n_pca = p27_rows("pca-int")
    km_rows = DP_PARTITIONS * DP_ROWS
    print(f"phase 28: the elastic fits across daemons; PCA d = {D}, k = {K} on phase 27's "
          f"{n_pca} rows in {{-1, 0, 1}}, KMeans d = {KM_D}, k = {KM_K} on {km_rows} integer "
          f"blob rows; partitions {P28_MOVED} feed the doomed peer (or the joiner), failing "
          f"over to the primary, {P28_SURVIVOR} the survivor; death timeout {P28_DEATH_S} s",
          flush=True)
    elastic = {"loss_tolerance": 1, "death_timeout_s": P28_DEATH_S, "max_op_attempts": 2}
    launches = 0

    def held(r, tag, folded):
        """The fit's launches: gram_colsum once a folded frame in this
        process, all on the wgmma route, no other kernel."""
        check(r["launches"]["gram_colsum"] == folded
              and r["routes"]["gram_colsum/wgmma"] == folded
              and sum(r["launches"].values()) == folded,
              f"phase {tag}: gram_colsum launches {r['launches']['gram_colsum']} == frames "
              f"folded in this process {folded}, all wgmma, no other kernel")

    def same_kmeans(m, ref, tag):
        p27_same(np, [("centers", m.centers, ref.centers)], f"phase {tag}: vs the oracle")
        cost = abs(m.summary.trainingCost - ref.summary.trainingCost) / ref.summary.trainingCost
        check(m.summary.numIter == ref.summary.numIter and cost <= 1e-6
              and m.summary.n_rows == km_rows,
              f"phase {tag}: numIter {m.summary.numIter} == the oracle's "
              f"{ref.summary.numIter}, cost rel err {cost:.3e} (tol 1e-6: f32 sums of the "
              f"same rows in another order), n_rows {m.summary.n_rows} == {km_rows}")

    ctx = mp.get_context("spawn")  # never fork a process that holds a CUDA context
    qd, stop = ctx.Queue(), ctx.Event()
    attrs = ("pc", "explainedVariance", "mean")
    with DataPlaneDaemon(host="127.0.0.1", port=0, device=DEV) as a, \
            DataPlaneDaemon(host="127.0.0.1", port=0, device=DEV) as c:
        t_spawn = time.perf_counter()
        # 28d's daemon process and both task pools start together (their
        # imports overlap); 28e's tasks inherit the fault plan's spec.
        victim = ctx.Process(target=_p27_daemon, args=(qd, stop, DEV), daemon=True)
        victim.start()
        pool = _P21Pool(a.address, P28_RUNS, wait=False)
        os.environ[faults.ENV_VAR] = P28_CHAOS
        try:
            # Spawned: a task forked by the fork server would not see the plan.
            chaos_pool = _P21Pool(a.address, P28_RUNS, wait=False, ctx=ctx)
        finally:
            os.environ.pop(faults.ENV_VAR, None)
        try:
            pool.ready()
            chaos_pool.ready()
            msg = qd.get(timeout=P27_DAEMON_TIMEOUT_S)
            check(msg[0] == "ready", f"phase 28d: the daemon process is up: {msg}")
            v_addr = ("127.0.0.1", msg[1])
            print(f"phase 28: two task pools and a daemon process ready in "
                  f"{time.perf_counter() - t_spawn:.1f} s", flush=True)

            def fit(pl, run, drive, tag, **kw):
                return p28_fit(torch, kernels, est, profiling, pl, a.address, run, drive, tag,
                               **kw)

            # -- the PCA oracle: phase 27's one-daemon fit, else one here ------
            pool.prepare("pca-int")
            chaos_pool.prepare("pca-int")
            pca_core = PCA(device=DEV).setK(K)

            def drive_pca(f, rp):
                return est._drive_pca(f, rp, pca_core)

            if P27_ORACLE:
                pca_oracle, pca_oracle_s = P27_ORACLE["model"], P27_ORACLE["s"]
                print(f"phase 28 PCA oracle: phase 27's one-daemon fit ({pca_oracle_s:.3f} s)",
                      flush=True)
            else:
                pca_oracle, r = fit(pool, "pca-int", drive_pca, "oracle")
                pca_oracle_s = r["s"]
                print(f"phase 28 PCA oracle: one daemon, {pca_oracle_s:.3f} s", flush=True)
            pca_frames = DP_PARTITIONS * DP_FEEDS

            # -- a. degrade, single pass, the collective path ------------------
            b = DataPlaneDaemon(host="127.0.0.1", port=0, device=DEV).start()
            marks = {}
            plan = FaultPlan(seed=P28_SEED).rule("daemon.vanish", "crash", times=1).on_crash(
                lambda: (marks.setdefault("a", time.perf_counter()), b.stop()))
            route = {**{p: [b.address, a.address] for p in P28_MOVED},
                     **{p: c.address for p in P28_SURVIVOR}}
            try:
                m, r = fit(pool, "pca-int", drive_pca, "28a", route=route, plan=plan, **elastic)
            finally:
                b.stop()
            check(plan.fired == {"daemon.vanish": 1} and r["counters"]["losses"] == 1
                  and r["counters"]["reroutes"] == 1 and r["scans"] == 2
                  and r["acked"] == n_pca,
                  f"phase 28a: the peer died at its first daemon.vanish ({plan.fired}), one "
                  f"loss and one reroute counted ({r['counters']}), the scan replayed "
                  f"({r['scans']} scans), {r['acked']} rows acked == {n_pca}")
            held(r, "28a", 2 * pca_frames)
            launches += r["launches"]["gram_colsum"]
            p27_same(np, p27_attrs(m, pca_oracle, attrs),
                     "phase 28a: the elastic PCA (collective) vs phase 27's one-daemon fit")
            p28_report(r, "28a", pca_oracle_s, marks.get("a"))

            # -- d. degrade across processes: a peer process SIGKILLed, the hub --
            pool.prepare("pca-int")  # after 28a's scans, before the kmeans frames
            killed = {}

            def kill(scan):
                if scan == 1:
                    victim.kill()  # SIGKILL, after its rows were committed and acked
                    victim.join(timeout=30)
                    killed.update(t=time.perf_counter(), code=victim.exitcode)

            route = {**{p: [v_addr, a.address] for p in P28_MOVED},
                     **{p: c.address for p in P28_SURVIVOR}}
            m, r = fit(pool, "pca-int", drive_pca, "28d", route=route, hub=True,
                       after_scan=kill, **elastic)
            check(killed.get("code") == -9 and r["counters"]["losses"] == 1
                  and r["scans"] == 2 and r["acked"] == n_pca,
                  f"phase 28d: the daemon process died by SIGKILL (exit {killed.get('code')}), "
                  f"one loss counted ({r['counters']}), {r['scans']} scans, {r['acked']} rows "
                  f"acked == {n_pca}")
            # The killed process folded its frames of the first scan itself.
            held(r, "28d", 2 * pca_frames - len(P28_MOVED) * DP_FEEDS)
            launches += r["launches"]["gram_colsum"]
            p27_same(np, p27_attrs(m, pca_oracle, attrs),
                     "phase 28d: the elastic PCA across processes (hub) vs phase 27's fit")
            p28_report(r, "28d", pca_oracle_s, killed.get("t"))

            # -- e. chaos: phase 20's feed protocol under the fault plan --------
            m, r = fit(chaos_pool, "pca-int", drive_pca, "28e",
                       plan=FaultPlan.from_spec(P28_CHAOS))
            stats = [ack.get("stats", {}) for ack in r["acks"]]
            rec_n = sum(st.get("reconnects", 0) for st in stats)
            rep_n = sum(st.get("replays", 0) for st in stats)
            check(rec_n > 0 and rep_n > 0 and r["acked"] == n_pca and r["scans"] == 1,
                  f"phase 28e: the tasks healed: {rec_n} reconnects, {rep_n} replays (both > "
                  f"0); {r['acked']} rows acked == {n_pca} in one scan")
            held(r, "28e", pca_frames)
            launches += r["launches"]["gram_colsum"]
            p27_same(np, p27_attrs(m, pca_oracle, attrs),
                     "phase 28e: the PCA under chaos vs the fault-free fit")
            p28_report(r, "28e", pca_oracle_s)

            # -- b. degrade, iterative: KMeans, the peer dies at the pass-1 sync --
            pool.prepare("kmeans-int")
            km_sample = p21_frame(np, P28_RUNS, "kmeans-int", 0, 0)[0][
                :est._kmeans_seed_rows(KM_K)]
            km_core = (KMeans(device=DEV).setK(KM_K).setMaxIter(P28_MAX_ITER).setTol(KM_TOL)
                       .setSeed(P28_SEED))

            def drive_km(f, rp):
                return est._drive_kmeans(f, rp, km_core, km_sample)

            survivor = {p: c.address for p in P28_SURVIVOR}
            km_oracle, r_o = fit(pool, "kmeans-int", drive_km, "kmeans-oracle", route=survivor,
                                 addresses=[a.address, c.address])
            check(sum(r_o["launches"].values()) == 0,
                  "phase 28 KMeans oracle: no kernel (the daemon's kmeans fold is plain, as "
                  "the reference's)")
            print(f"phase 28 KMeans oracle: {km_oracle.summary.numIter} passes, "
                  f"{r_o['s']:.3f} s", flush=True)
            b = DataPlaneDaemon(host="127.0.0.1", port=0, device=DEV).start()
            marks = {}
            # Hits: pass 0's reduce and two pushes, pass 1's reduce; the fifth
            # is pass 1's first push.
            plan = FaultPlan(seed=P28_SEED).rule("daemon.vanish", "crash", after=4,
                                                 times=1).on_crash(
                lambda: (marks.setdefault("b", time.perf_counter()), b.stop()))
            route = {**{p: [b.address, a.address] for p in P28_MOVED}, **survivor}
            try:
                m, r = fit(pool, "kmeans-int", drive_km, "28b", route=route,
                           addresses=[a.address, b.address, c.address], plan=plan, **elastic)
            finally:
                b.stop()
            check(plan.fired == {"daemon.vanish": 1} and r["counters"]["losses"] == 1
                  and r["counters"]["reroutes"] == 1 and sum(r["launches"].values()) == 0,
                  f"phase 28b: the peer died at the pass-1 boundary sync ({plan.fired}), one "
                  f"loss and one reroute ({r['counters']}), no kernel")
            same_kmeans(m, km_oracle, "28b")
            p28_report(r, "28b", r_o["s"], marks.get("b"))

            # -- c. grow: a daemon added to the configured set at a boundary ---
            b = DataPlaneDaemon(host="127.0.0.1", port=0, device=DEV).start()
            marks = {}
            grown = ",".join("%s:%d" % d.address for d in (a, b, c))

            def appear():
                marks.setdefault("c", time.perf_counter())
                os.environ["SRML_DAEMON_ADDRESSES"] = grown

            # Both client attempts of pass 0's first push fail; the callback
            # is Spark's dynamic allocation re-pointing the daemon set.
            plan = FaultPlan(seed=P28_SEED).rule("daemon.vanish", "crash", after=1,
                                                 times=2).on_crash(appear)
            route = {**{p: [b.address, a.address] for p in P28_MOVED}, **survivor}
            try:
                m, r = fit(pool, "kmeans-int", drive_km, "28c", route=route,
                           addresses=[a.address, c.address], plan=plan,
                           join_policy="boundary", max_op_attempts=2)
                moved = len(P28_MOVED) * DP_ROWS
                check(plan.fired == {"daemon.vanish": 2} and r["counters"]["joins"] == 1
                      and r["counters"]["rebalanced"] == moved and not b._jobs,
                      f"phase 28c: one join ({r['counters']}), rebalanced rows == the "
                      f"{moved} rows of partitions {P28_MOVED}, the joiner's job dropped")
            finally:
                b.stop()
            same_kmeans(m, km_oracle, "28c")
            p28_report(r, "28c", r_o["s"], marks.get("c"))
        finally:
            pool.close()
            chaos_pool.close()
            if victim.is_alive():
                # Only a live process: setting an Event that a SIGKILLed
                # process was waiting on blocks for its acknowledgement.
                stop.set()
                victim.join(timeout=30)
            if victim.is_alive():
                victim.terminate()
                victim.join(timeout=10)
        check(not a._jobs and not c._jobs, "phase 28: no job left on the survivors")
    torch.cuda.empty_cache()
    print(f"phase 28: {time.perf_counter() - t_phase:.1f} s; elastic_launches "
          f"{{'gram_colsum': {launches}}}", flush=True)
    return {"gram_colsum": launches}


P29_SEED = 29
P29_PROCS = 8  # the wire clients: spawned processes, so the rates are not the interpreter's
P29_REQS = 32  # exact kneighbors requests a client process
P29_Q_SIZES = (1, 16, 63, 64, 65, 256)  # query counts of a request
P29_IVF_ROWS, P29_IVF_NLIST, P29_IVF_NPROBE = 65536, 64, 8
P29_IVF_REQS = 4  # IVF requests a client process
P29_SHED_REQS = 8  # requests a client process sends to the queue-depth-2 daemon
P29_SHED_DEPTH = 2
P29_PCA_ROWS = 65536  # the served PCA model's fit rows (phase 3's spectrum)
P29_PCA_THREADS, P29_PCA_REQS = 16, 64  # in-process submitters x requests each
P29_PCA_SIZES = (1, 8, 63, 64, 65, 200, 1000)
P29_PCA_POOL = 8192  # rows the transform requests are sliced from
P29_TIMEOUT_S = 300  # a client command's time limit


def p29_requests(np, p, d, clusters):
    """Client ``p``'s exact kNN requests: query counts drawn from
    P29_Q_SIZES by the seed (P29_SEED, p), the queries bench_knn.py's
    mixture (``knn_frame`` of partition 16 + p, frame 0)."""
    sizes = np.random.default_rng([P29_SEED, p]).choice(P29_Q_SIZES, P29_REQS)
    q = knn_frame(np, 16 + p, 0, int(sizes.sum()), d, clusters)
    offs = np.concatenate([[0], np.cumsum(sizes)])
    return [q[offs[i]:offs[i + 1]] for i in range(P29_REQS)]


def _p29_client(p, shape, cmd_q, out_q):
    """Phase 29's wire client ``p``: a spawned process that feeds its
    partition of the exact index (("feed", address, job)) and runs request
    lists against a daemon (("run", name, address, model, k, n)): the first
    n of its requests, one ``kneighbors_raw`` each over one connection,
    timed on the host clock. It keeps each run's answers, and ("compare",
    a, b) reports the requests whose answers differ in a bit. ``shape``:
    (width, rows a frame, frames, mixture components)."""
    try:
        import numpy as np

        from spark_rapids_ml_tpu_torch.serve.client import DataPlaneClient
    except Exception as e:  # noqa: BLE001 - reported to the parent
        out_q.put(("err", p, repr(e)))
        return
    d, rows, feeds, clusters = shape
    reqs = p29_requests(np, p, d, clusters)
    out_q.put(("ready", p, None))
    answers = {}
    while True:
        cmd = cmd_q.get()
        if cmd is None:
            return
        try:
            if cmd[0] == "feed":
                _, address, job = cmd
                with DataPlaneClient(*address, timeout=600.0) as c:
                    for f in range(feeds):
                        x = knn_frame(np, p, f, rows, d, clusters)
                        c.feed_raw(job, x, algo="knn", n_cols=d, partition=p)
                    out_q.put(("ok", p, c.commit(job, partition=p)))
            elif cmd[0] == "run":
                _, name, address, model, k, n = cmd
                lat, got = [], []
                with DataPlaneClient(*address, timeout=600.0) as c:
                    t_run = time.perf_counter()
                    for q in reqs[:n]:
                        t0 = time.perf_counter()
                        got.append(c.kneighbors_raw(model, q, k=k))
                        lat.append(time.perf_counter() - t0)
                    run_s = time.perf_counter() - t_run
                    stats = dict(c.stats)
                answers[name] = got
                out_q.put(("ok", p, {"lat": lat, "rows": sum(q.shape[0] for q in reqs[:n]),
                                     "s": run_s, "stats": stats}))
            elif cmd[0] == "compare":
                _, a, b = cmd
                bad = [i for i, ((da, ia), (db, ib)) in enumerate(zip(answers[a], answers[b]))
                       if not (np.array_equal(da, db) and np.array_equal(ia, ib))]
                out_q.put(("ok", p, {"bad": bad, "n": min(len(answers[a]), len(answers[b]))}))
        except Exception as e:  # noqa: BLE001 - reported to the parent
            out_q.put(("err", p, repr(e)))


class _P29Clients:
    """The P29_PROCS wire clients, spawned once (never fork a process that
    holds a CUDA context) and driven by commands."""

    def __init__(self):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.out = ctx.Queue()
        self.cmds = [ctx.Queue() for _ in range(P29_PROCS)]
        shape = (KNN_D, DP_ROWS, DP_FEEDS, KNN_CLUSTERS)
        self.procs = [ctx.Process(target=_p29_client, args=(p, shape, self.cmds[p], self.out),
                                  daemon=True) for p in range(P29_PROCS)]
        for proc in self.procs:
            proc.start()

    def collect(self, want="ok"):
        msgs = [self.out.get(timeout=P29_TIMEOUT_S) for _ in self.procs]
        bad = [m for m in msgs if m[0] != want]
        if bad:
            fail(f"phase 29 client processes failed: {bad}")
        return [m[2] for m in sorted(msgs, key=lambda m: m[1])]

    def all(self, *cmd):
        for q in self.cmds:
            q.put(cmd)
        return self.collect()

    def close(self):
        for q in self.cmds:
            q.put(None)
        for proc in self.procs:
            proc.join(timeout=30)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=10)


def p29_share(daemon, name, served):
    """Register a built model of another daemon in ``daemon`` too (the
    rows were fed once), as the daemon's knn finalize registers its own."""
    from spark_rapids_ml_tpu_torch.serve import daemon as daemon_mod

    shared = daemon_mod._ServedModel.from_model(served.algo, served.model, id_map=served.id_map,
                                                buckets=daemon._buckets)
    with daemon._models_lock:
        daemon._models[name] = shared
    return shared


def p29_metric(snap, name, field="value", **labels):
    """The sum of a metric's samples (a histogram's ``field``: sum or
    count) whose labels include ``labels``."""
    return sum(s[field] for s in snap.get(name, {}).get("samples", [])
               if all(s["labels"].get(k) == v for k, v in labels.items()))


def p29_delta(before, after, name, field="value", **labels):
    """What a metric gained between two snapshots."""
    return (p29_metric(after, name, field, **labels)
            - p29_metric(before, name, field, **labels))


def p29_traffic(torch, kernels, clients, name, address, model, k, n, tag):
    """One traffic run of every client against ``address``, launches reset
    just before and read just after, traced for the device busy share.
    Returns a record: requests, rows, seconds, latencies, launches, routes,
    busy ms."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    kernels.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = clients.all("run", name, address, model, k, n)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
    rec = {"launches": dict(kernels.LAUNCHES), "routes": dict(kernels.ROUTES), "s": wall}
    rec["busy_ms"], _, _ = device_time(torch, prof)
    del prof
    lat = np.sort(np.concatenate([r["lat"] for r in res])) * 1e3
    rec.update(requests=len(lat), rows=sum(r["rows"] for r in res),
               p50=float(np.percentile(lat, 50)), p99=float(np.percentile(lat, 99)),
               busy_waits=sum(r["stats"]["busy_waits"] for r in res))
    print(f"phase 29 {tag}: {rec['requests']} requests, {rec['rows']} query rows from "
          f"{P29_PROCS} processes in {wall:.3f} s = {rec['requests'] / wall:.1f} requests/s, "
          f"{rec['rows'] / wall:.1f} rows/s; latency p50 {rec['p50']:.3f} ms, p99 "
          f"{rec['p99']:.3f} ms (host clock in the clients); device busy {rec['busy_ms']:.3f} "
          f"ms of {wall * 1e3:.3f} ({100 * rec['busy_ms'] / (wall * 1e3):.2f} %, torch.profiler)",
          flush=True)
    return rec


def phase_serving(torch, kernels, config):
    """Phase 29: the serving plane on the card (``serve/scheduler.py``, the
    ``warmup``, ``health`` and ``metrics`` ops). Returns the launches of
    its batched exact traffic and its IVF traffic ({kernel: launches})."""
    import threading

    import numpy as np

    from spark_rapids_ml_tpu_torch import PCA
    from spark_rapids_ml_tpu_torch.serve import DataPlaneClient, DataPlaneDaemon
    from spark_rapids_ml_tpu_torch.serve.scheduler import RequestScheduler, bucket_for
    from spark_rapids_ml_tpu_torch.utils import metrics as metrics_mod
    from spark_rapids_ml_tpu_torch.utils import profiling

    t_phase = time.perf_counter()
    n_rows = DP_PARTITIONS * DP_FEEDS * DP_ROWS
    print(f"phase 29: the serving plane; {P29_PROCS} client processes x {P29_REQS} exact "
          f"kneighbors_raw requests of {P29_Q_SIZES} queries (k = {KNN_K}) over phase 22's "
          f"{n_rows} x {KNN_D} rows, batching on against off; IVF ({P29_IVF_ROWS} rows, nlist "
          f"{P29_IVF_NLIST}, nprobe {P29_IVF_NPROBE}) bypassing; a queue-depth-{P29_SHED_DEPTH} "
          f"daemon shedding; {P29_PCA_THREADS} threads x {P29_PCA_REQS} PCA transforms "
          f"(d = {D}, k = {K}) through RequestScheduler.submit", flush=True)
    clients = _P29Clients()  # their imports overlap the daemons' set-up
    out = {}
    with DataPlaneDaemon(device=DEV, serve_batching=True) as on, \
            DataPlaneDaemon(device=DEV, serve_batching=False) as off:
        with config.option("serve_queue_depth", P29_SHED_DEPTH):
            shed = DataPlaneDaemon(device=DEV, serve_batching=True, retry_after_s=0.01).start()
        try:
            # -- the served models -------------------------------------------
            gen = torch.Generator(device=DEV).manual_seed(P29_SEED)
            j = torch.arange(D, device=DEV, dtype=torch.float32)
            scales = torch.where(j < K, torch.sqrt(2.0 - j / (K - 1)), 0.1 * 0.999 ** j)
            mu = 0.05 * torch.randn((D,), generator=gen, device=DEV)
            pca = PCA(device=DEV).setK(K).fit({"features": make_rows(gen, P29_PCA_ROWS, scales,
                                                                     mu, torch.float32)})
            x_pool = make_rows(gen, P29_PCA_POOL, scales, mu, torch.float32).cpu().numpy()
            for d in (on, off):
                with DataPlaneClient(*d.address) as c:
                    c.ensure_model("p29-pca", "pca", pca._model_data())
            with DataPlaneClient(*on.address) as c:
                c.feed_raw("p29-ivf", knn_frame(np, 0, 0, P29_IVF_ROWS, KNN_D, KNN_CLUSTERS),
                           algo="knn", n_cols=KNN_D)
                c.finalize_knn("p29-ivf", register_as="p29-ivf", mode="ivf",
                               nlist=P29_IVF_NLIST, nprobe=P29_IVF_NPROBE, seed=P29_SEED)
            p29_share(off, "p29-ivf", on._lookup_model("p29-ivf"))
            clients.collect("ready")
            t0 = time.perf_counter()
            acks = clients.all("feed", on.address, "p29-exact")
            feed_s = time.perf_counter() - t0
            with DataPlaneClient(*on.address) as c:
                t0 = time.perf_counter()
                info = c.finalize_knn("p29-exact", register_as="p29-exact", mode="exact")
                build_s = time.perf_counter() - t0
            check(int(info["n_rows"][0]) == n_rows == max(acks),
                  f"phase 29 exact index: {int(info['n_rows'][0])} rows fed by the clients' "
                  f"feed_raw frames == {n_rows}")
            print(f"phase 29 exact index fed in {feed_s:.3f} s ({n_rows / feed_s:.1f} rows/s), "
                  f"built in {build_s:.3f} s", flush=True)
            exact_on = on._lookup_model("p29-exact")
            exact_on.model._set(k=KNN_K)  # the served index's fitted k
            p29_share(off, "p29-exact", exact_on)
            p29_share(shed, "p29-exact", exact_on)
            # -- warmup --------------------------------------------------------
            ladder = list(on._buckets)
            for d, model, width, kw in ((on, "p29-exact", KNN_D, {"k": KNN_K}),
                                        (on, "p29-ivf", KNN_D, {"k": KNN_K}),
                                        (on, "p29-pca", D, {}),
                                        (shed, "p29-exact", KNN_D, {"k": KNN_K})):
                with DataPlaneClient(*d.address) as c:
                    t0 = time.perf_counter()
                    ack = c.warmup(model, n_cols=width, **kw)
                    warm_s = time.perf_counter() - t0
                tag = "the shedding daemon's " if d is shed else ""
                check(ack == {"enabled": True, "buckets": ladder, "compiled": len(ladder),
                              "aot": False},
                      f"phase 29 warmup of {tag}{model}: {ack} ({warm_s:.3f} s, host clock)")
            # -- exact kNN over the wire: batching on, then off ----------------
            # The registry is the process's: every count below is a delta
            # since the warmups.
            metrics_mod.reset()
            rec_on = p29_traffic(torch, kernels, clients, "on", on.address, "p29-exact",
                                 KNN_K, P29_REQS, "exact kNN, batching on")
            snap = metrics_mod.snapshot()
            batches = p29_metric(snap, "srml_scheduler_batches_total", op="kneighbors")
            batched = p29_metric(snap, "srml_scheduler_batched_requests_total", op="kneighbors")
            b_rows = p29_metric(snap, "srml_scheduler_batch_rows", "sum", op="kneighbors")
            padded = p29_metric(snap, "srml_scheduler_padded_rows_total", op="kneighbors")
            n_req = P29_PROCS * P29_REQS
            lt, rt = rec_on["launches"], rec_on["routes"]
            check(batched == n_req and b_rows == rec_on["rows"] and 0 < batches < n_req,
                  f"phase 29 batching on: {int(batched)} requests in {int(batches)} batches "
                  f"(fewer than the {n_req} requests), {int(b_rows)} rows")
            check(lt["dist_topk"] == batches and rt["dist_topk/wgmma"] == lt["dist_topk"]
                  and sum(lt.values()) == lt["dist_topk"],
                  f"phase 29 batching on: dist_topk launches {lt['dist_topk']} == "
                  f"srml_scheduler_batches_total{{op=kneighbors}} {int(batches)}, all on the "
                  f"tensor-core route ({rt['dist_topk/wgmma']}), no other kernel")
            out["dist_topk"] = lt["dist_topk"]
            print(f"phase 29 batching on: mean {b_rows / batches:.1f} rows a batch, padded share "
                  f"{padded / (padded + b_rows):.4f} ({int(padded)} padding rows)", flush=True)
            rec_off = p29_traffic(torch, kernels, clients, "off", off.address, "p29-exact",
                                  KNN_K, P29_REQS, "exact kNN, batching off")
            check(rec_off["launches"]["dist_topk"] == n_req,
                  f"phase 29 batching off: one dist_topk launch a request "
                  f"({rec_off['launches']['dist_topk']} == {n_req})")
            bad = clients.all("compare", "on", "off")
            n_bad = sum(len(r["bad"]) for r in bad)
            check(n_bad == 0, f"phase 29 exact kNN: every batched answer bitwise equal to the "
                              f"batching-off daemon's ({n_bad} of {n_req} differ)")
            print(f"phase 29 exact kNN batching on / off: {rec_on['requests'] / rec_on['s']:.1f}"
                  f" / {rec_off['requests'] / rec_off['s']:.1f} requests/s "
                  f"({rec_off['s'] / rec_on['s']:.2f}x), p50 {rec_on['p50']:.3f}"
                  f" / {rec_off['p50']:.3f} ms, p99 {rec_on['p99']:.3f} / {rec_off['p99']:.3f} "
                  f"ms, device busy {100 * rec_on['busy_ms'] / (rec_on['s'] * 1e3):.2f} / "
                  f"{100 * rec_off['busy_ms'] / (rec_off['s'] * 1e3):.2f} %", flush=True)
            # -- health and metrics --------------------------------------------
            with DataPlaneClient(*on.address) as c:
                deadline = time.monotonic() + 10.0
                while True:  # a request counts once its answer is on the wire
                    snap = c.metrics()
                    counted = p29_metric(snap, "srml_daemon_requests_total", op="kneighbors")
                    if counted >= 2 * n_req or time.monotonic() > deadline:
                        break
                    time.sleep(0.01)
                text = c.metrics(format="prometheus")
                health = c.health()
            check(counted == 2 * n_req and p29_metric(snap, "srml_daemon_requests_total",
                                                      op="kneighbors", outcome="ok") == 2 * n_req,
                  f"phase 29 metrics: srml_daemon_requests_total{{op=kneighbors}} {int(counted)}"
                  f" == the {2 * n_req} requests sent (batching on and off)")
            sched = health["scheduler"]
            check(set(sched) == {"enabled", "window_ms", "max_batch_rows", "buckets",
                                 "queue_depth_cap", "queued", "models", "batches"}
                  and sched["enabled"] and sched["buckets"] == ladder
                  and sched["batches"] >= batches and sched["queued"] == 0
                  and health["durable"] is False,
                  f"phase 29 health: the scheduler block {sched}")
            lines = text.splitlines()
            check(any(ln.startswith('srml_scheduler_batches_total{op="kneighbors"}')
                      for ln in lines)
                  and f'srml_daemon_requests_total{{op="kneighbors",outcome="ok"}} {2 * n_req}'
                  in lines,
                  "phase 29 metrics (prometheus): the srml_scheduler_batches_total and "
                  "srml_daemon_requests_total lines")
            # -- IVF: never coalesced -----------------------------------------
            before = metrics_mod.snapshot()
            rec_ivf = p29_traffic(torch, kernels, clients, "ivf-on", on.address, "p29-ivf",
                                  KNN_K, P29_IVF_REQS, "IVF, batching on (bypassed)")
            n_ivf = P29_PROCS * P29_IVF_REQS
            bypass = p29_delta(before, metrics_mod.snapshot(), "srml_scheduler_bypass_total",
                               op="kneighbors")
            li, ri = rec_ivf["launches"], rec_ivf["routes"]
            check(bypass == n_ivf and li["probe_select"] == li["ivf_scan_select"] == n_ivf
                  and ri["ivf_scan_select/wgmma"] == n_ivf,
                  f"phase 29 IVF: srml_scheduler_bypass_total{{op=kneighbors}} {int(bypass)} == "
                  f"{n_ivf} requests; probe_select {li['probe_select']}, ivf_scan_select "
                  f"{li['ivf_scan_select']} (wgmma {ri['ivf_scan_select/wgmma']}), one each a "
                  f"request")
            out["probe_select"], out["ivf_scan_select"] = li["probe_select"], li["ivf_scan_select"]
            p29_traffic(torch, kernels, clients, "ivf-off", off.address, "p29-ivf", KNN_K,
                        P29_IVF_REQS, "IVF, batching off")
            bad = clients.all("compare", "ivf-on", "ivf-off")
            n_bad = sum(len(r["bad"]) for r in bad)
            check(n_bad == 0, f"phase 29 IVF: every answer bitwise equal to the batching-off "
                              f"daemon's ({n_bad} of {n_ivf} differ)")
            # -- shedding --------------------------------------------------------
            before = metrics_mod.snapshot()
            rec_shed = p29_traffic(torch, kernels, clients, "shed", shed.address, "p29-exact",
                                   KNN_K, P29_SHED_REQS,
                                   f"exact kNN, queue depth {P29_SHED_DEPTH}")
            sheds = p29_delta(before, metrics_mod.snapshot(), "srml_daemon_busy_sheds_total",
                              op="kneighbors")
            bad = clients.all("compare", "shed", "off")
            n_bad = sum(len(r["bad"]) for r in bad)
            check(sheds > 0 and rec_shed["busy_waits"] > 0 and n_bad == 0,
                  f"phase 29 shedding: {int(sheds)} busy answers "
                  f"(srml_daemon_busy_sheds_total), {rec_shed['busy_waits']} client busy "
                  f"waits, every healed answer bitwise the batching-off daemon's ({n_bad} of "
                  f"{P29_PROCS * P29_SHED_REQS} differ)")
            # -- the PCA transform through RequestScheduler.submit -------------------
            pca_on, pca_off = on._lookup_model("p29-pca"), off._lookup_model("p29-pca")
            cd = config.compute_dtype(DEV)
            pc_abs = torch.as_tensor(pca.pc, device=DEV).to(cd).double().abs()
            gamma = 2048 * 2.0 ** -24 / (1 - 2048 * 2.0 ** -24)  # γ₂₀₄₈ of f32 sums
            gen_rq = np.random.default_rng([P29_SEED, 1])
            plans = [[(int(n), int(gen_rq.integers(0, P29_PCA_POOL - n + 1)))
                      for n in gen_rq.choice(P29_PCA_SIZES, P29_PCA_REQS)]
                     for _ in range(P29_PCA_THREADS)]
            results = [[None] * P29_PCA_REQS for _ in range(P29_PCA_THREADS)]
            errors = []
            barrier = threading.Barrier(P29_PCA_THREADS)

            def submitter(t):
                try:
                    barrier.wait()
                    for i, (n, o) in enumerate(plans[t]):
                        results[t][i] = on._scheduler.submit("p29-pca", pca_on, "transform",
                                                            x_pool[o:o + n])["output"]
                except Exception as e:  # noqa: BLE001 - reported below
                    errors.append(repr(e))

            before = metrics_mod.snapshot()
            threads = [threading.Thread(target=submitter, args=(t,))
                       for t in range(P29_PCA_THREADS)]
            t0 = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            pca_s = time.perf_counter() - t0
            check(not errors, f"phase 29 PCA submitters: {errors[:3]}")
            snap = metrics_mod.snapshot()
            p_batches = p29_delta(before, snap, "srml_scheduler_batches_total", op="transform")
            p_rows = p29_delta(before, snap, "srml_scheduler_batch_rows", "sum", op="transform")
            n_pca = P29_PCA_THREADS * P29_PCA_REQS
            same, worst, over = 0, 0.0, []
            for t in range(P29_PCA_THREADS):
                for i, (n, o) in enumerate(plans[t]):
                    x = x_pool[o:o + n]
                    want = pca_off.transform(x)["output"]
                    got = results[t][i]
                    if got.shape == want.shape and np.array_equal(got, want):
                        same += 1
                        continue
                    xa = torch.as_tensor(x, device=DEV).to(cd).double().abs()
                    bound = (2 * gamma * (xa @ pc_abs)).cpu().numpy()
                    err = np.abs(got.astype(np.float64) - want.astype(np.float64))
                    if got.shape != want.shape or not bool((err <= bound).all()):
                        over.append((t, i, n))
                    worst = max(worst, float((err / np.maximum(bound, 1e-300)).max()))
            check(not over, f"phase 29 PCA: every answer bitwise the batching-off daemon's solo "
                            f"transform or within 2·γ₂₀₄₈·Σ|x||pc| of it (over: {over[:5]})")
            print(f"phase 29 PCA transform: {n_pca} requests in {int(p_batches)} batches "
                  f"({p_rows / max(p_batches, 1):.1f} rows a batch) in {pca_s:.3f} s = "
                  f"{n_pca / pca_s:.1f} requests/s from {P29_PCA_THREADS} threads; {same} of "
                  f"{n_pca} answers bitwise the solo transform's, the rest within the bound "
                  f"(largest error {worst:.3f} of it)", flush=True)
            check(0 < p_batches < n_pca, f"phase 29 PCA: {int(p_batches)} batches for {n_pca} "
                                         f"requests")
            # Within one bucket a batched request is the solo request's bits: 9
            # rows coalesced with 40 (one batch of 49 rows: the 64 bucket) beside
            # the same 9 rows served alone (padded to 64).
            probe = RequestScheduler(window_ms=200.0, buckets=on._buckets).start()
            try:
                pair = [None, None]

                def sub(i, rows):
                    pair[i] = probe.submit("p29-pca", pca_on, "transform", rows)["output"]

                ths = [threading.Thread(target=sub, args=(0, x_pool[:9])),
                       threading.Thread(target=sub, args=(1, x_pool[100:140]))]
                for th in ths:
                    th.start()
                for th in ths:
                    th.join()
                probe_batches = probe._batches
            finally:
                probe.stop()
            check(probe_batches == 1 and bucket_for(49, on._buckets) == bucket_for(9, on._buckets)
                  and np.array_equal(pair[0], pca_off.transform(x_pool[:9])["output"]),
                  "phase 29 PCA: 9 rows batched with 40 (the 64-row bucket) bitwise the 9 rows "
                  "served alone")
            misses = metrics_mod.REGISTRY.counter("srml_scheduler_compile_misses_total")
            check(sum(misses.value(op=o) for o in ("transform", "kneighbors")) == 0,
                  "phase 29: no traffic after the warmups met an unseen shape "
                  "(srml_scheduler_compile_misses_total 0)")
            # -- one 4,096-query request alone (phase 22's): what the path adds --
            qs = knn_frame(np, DP_PARTITIONS, 0, KNN_QUERIES, KNN_D, KNN_CLUSTERS)
            names = ("daemon frame receive", "daemon frame decode", "scheduler kneighbors",
                     "daemon kneighbors", "knn query")
            with DataPlaneClient(*on.address) as c_on, DataPlaneClient(*off.address) as c_off:
                for tag, fn in (
                        ("over the wire, batching on",
                         lambda: c_on.kneighbors_raw("p29-exact", qs, k=KNN_K)),
                        ("over the wire, batching off",
                         lambda: c_off.kneighbors_raw("p29-exact", qs, k=KNN_K)),
                        ("in process, RequestScheduler.submit",
                         lambda: on._scheduler.submit("p29-exact", exact_on, "kneighbors", qs,
                                                      k=KNN_K)),
                        ("in process, _ServedModel.kneighbors",
                         lambda: exact_on.kneighbors(qs, KNN_K))):
                    fn()  # warm
                    profiling.reset_span_totals()
                    times = []
                    for _ in range(5):
                        t0 = time.perf_counter()
                        fn()
                        times.append(time.perf_counter() - t0)
                    spans = profiling.span_totals()
                    print(f"phase 29 one {KNN_QUERIES}-query request, {tag}: median "
                          f"{sorted(times)[2] * 1e3:.3f} ms of 5 (host clock); spans, ms a "
                          "call: " + ", ".join(f"{nm} {spans[nm][0] / spans[nm][1] * 1e3:.3f}"
                                               for nm in names if nm in spans), flush=True)
        finally:
            clients.close()
            shed.stop()
    torch.cuda.empty_cache()
    print(f"phase 29: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


P30_SEED = 30
P30_REQS = 16  # phase 29's exact requests a client process, per traffic run
P30_TICK_S = 0.5  # the daemon's telemetry cadence in phase 30
P30_SLO = "kneighbors:p99_ms=0.001@0.01"  # 1 µs: every request violates it
P30_MICRO_CALLS = 500  # dist_topk calls a block of the ledger's cost
P30_SPANS = 20000  # journal spans a block of the journal's cost


def p30_span_ids(events):
    return {e.get("span_id") for e in events if e.get("event") == "phase"}


def p30_traffic(torch, kernels, clients, name, address, tag):
    """One run of every phase 29 client's first P30_REQS exact requests
    against ``address`` (no profiler: the rates are what (d) compares).
    Returns (requests/s, launches, routes)."""
    import numpy as np

    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = clients.all("run", name, address, "p30-exact", KNN_K, P30_REQS)
    wall = time.perf_counter() - t0
    n = P29_PROCS * P30_REQS
    lat = np.sort(np.concatenate([r["lat"] for r in res])) * 1e3
    print(f"phase 30 {tag}: {n} requests from {P29_PROCS} processes in {wall:.3f} s = "
          f"{n / wall:.1f} requests/s; p50 {float(np.percentile(lat, 50)):.3f} ms, p99 "
          f"{float(np.percentile(lat, 99)):.3f} ms (host clock in the clients)", flush=True)
    return n / wall, dict(kernels.LAUNCHES), dict(kernels.ROUTES)


def phase_telemetry(torch, kernels, config):
    """Phase 30: the observability plane on the card. Returns the launches
    of its two paths ({kernel: launches})."""
    import multiprocessing as mp
    import tempfile
    import threading

    import numpy as np

    from spark_rapids_ml_tpu_torch import NearestNeighbors
    from spark_rapids_ml_tpu_torch.serve import DataPlaneClient, DataPlaneDaemon
    from spark_rapids_ml_tpu_torch.serve import daemon as daemon_mod
    from spark_rapids_ml_tpu_torch.spark import estimator as est
    from spark_rapids_ml_tpu_torch.utils import flight, journal, xprof
    from spark_rapids_ml_tpu_torch.utils import metrics as metrics_mod

    t_phase = time.perf_counter()
    n_rows = DP_PARTITIONS * DP_FEEDS * DP_ROWS
    folded = DP_PARTITIONS * DP_FEEDS + 1  # every feed and the dead attempt's one
    print(f"phase 30: the observability plane; a. phase 20's feed protocol ({DP_PARTITIONS} "
          f"task processes x {DP_FEEDS} feed_raw frames of {DP_ROWS} x {D} f32) inside the "
          f"driver's journal run, device_timing on; b. {P29_PROCS} client processes x "
          f"{P30_REQS} of phase 29's exact requests over a {KNN_ROWS} x {KNN_D} bf16 index "
          f"(k = {KNN_K}) through the scheduler; c. the SLO {P30_SLO!r} and an incident "
          f"bundle; d. requests/s with the journal off, the ring armed, a journal file",
          flush=True)
    clients = _P29Clients()  # their imports overlap part a
    tmp = tempfile.TemporaryDirectory(prefix="srml-phase30-")
    out = {}
    ring_held = False
    try:
        # -- a. the Spark PCA feed protocol inside the driver's run ----------------
        ctx = mp.get_context("spawn")
        q, go = ctx.Queue(), ctx.Event()
        procs = []
        with config.option("telemetry_eval_interval_s", P30_TICK_S), \
                DataPlaneDaemon(device=DEV) as daemon:
            try:
                with journal.run("fit", estimator="SparkPCA", algo="pca") as run_id:
                    tc = journal.trace_ctx()
                    procs = [ctx.Process(target=_spark_task,
                                         args=(daemon.address, p, DP_ROWS, D, K, DP_FEEDS, go, q,
                                               tc), daemon=True)
                             for p in range(DP_PARTITIONS)]
                    for proc in procs:
                        proc.start()
                    for _ in procs:
                        msg = q.get(timeout=300)
                        if msg[0] != "ready":
                            fail(f"phase 30 task {msg[1]} failed before it was ready: {msg[2]}")
                    fit = est._DaemonFit(*daemon.address, SPARK_JOB)
                    torch.cuda.synchronize()
                    kernels.reset_launches()
                    xprof.reset()
                    with config.option("device_timing", True):
                        t0 = time.perf_counter()
                        go.set()
                        results = [q.get(timeout=600) for _ in procs]
                        bad = [r for r in results if r[0] != "ok"]
                        check(not bad, f"phase 30 tasks all succeeded: {bad}")
                        acks = [r[2] for r in results]
                        n = fit.account(acks)
                        arrays, fin_rows = fit.finalize_guarded({"k": K, "mean_center": True},
                                                                pass_rows_expected=n)
                        fit_s = time.perf_counter() - t0
                        fit.close()
            finally:
                for proc in procs:
                    proc.join(timeout=30 if go.is_set() else 0)
                    if proc.is_alive():
                        proc.terminate()
                        proc.join(timeout=10)
            launches = kernels.LAUNCHES["gram_colsum"]
            wgmma = kernels.ROUTES["gram_colsum/wgmma"]
            with DataPlaneClient(*daemon.address) as c:
                pulled = c.trace_pull(0)
        model = est._pca_model(arrays, device=DEV)
        check(n == fin_rows == n_rows and model.pc.shape == (D, K)
              and bool(np.isfinite(model.pc).all()),
              f"phase 30a fit: {n} rows acked, {fin_rows} finalized == {n_rows}; pc finite, "
              f"shape {model.pc.shape}")
        feeds = [e for e in pulled["events"]
                 if e.get("event") == "phase" and e.get("name") == "daemon.feed_raw"]
        check(len(feeds) == folded and all(e["run_id"] == run_id and e["parent_id"] == tc["span"]
                                           for e in feeds),
              f"phase 30a trace_pull: {len(feeds)} daemon.feed_raw spans == {folded} feeds, every "
              f"one in the driver's run {run_id} under its fit span")
        led = xprof.snapshot().get("gram_colsum", {})
        flops = DP_ROWS * D * (D + 1) + DP_ROWS * D
        sigs = led.get("signatures", [])
        check(led.get("calls") == launches == folded == wgmma
              and led.get("routes") == {"wgmma": folded}
              and all(sg["flops"] == flops for sg in sigs)
              and led.get("execute_calls") == folded,
              f"phase 30a kernel ledger: gram_colsum calls {led.get('calls')} == LAUNCHES "
              f"{launches} == {folded} folded feeds, routes {led.get('routes')}, flops a call "
              f"{[sg['flops'] for sg in sigs]} == {DP_ROWS}·{D}·{D + 1} + {DP_ROWS}·{D}, "
              f"{led.get('execute_calls')} timed calls")
        per_call = led["execute_s"] / led["execute_calls"]
        print(f"phase 30a: fit {n_rows} rows in {fit_s:.3f} s with device_timing on (a sync a "
              f"fold); gram_colsum execute_s {per_call * 1e3:.4f} ms a call over "
              f"{led['execute_calls']} calls (CUDA events), {flops / per_call / 1e12:.1f} "
              f"TFLOP/s; PERF.md row 1: 0.576 ms at 65,536 rows", flush=True)
        print("phase 30a kernel ledger:\n" + xprof.format_table(
            peak_flops_per_s=PEAK_FLOPS["bfloat16"], peak_bytes_per_s=PEAK_BYTES_PER_S),
            flush=True)
        # The same launch in this process, back to back and each after an
        # idle gap as long as a frame's receive: the card's clocks after a
        # host-bound gap against row 1's warm loop.
        xb = torch.randn((DP_ROWS, D), generator=torch.Generator(device=DEV).manual_seed(P30_SEED),
                         device=DEV).to(torch.bfloat16)
        st = (torch.zeros((D, D), device=DEV), torch.zeros(D, device=DEV),
              torch.zeros((), device=DEV))
        # And with 8 threads holding the GIL in turns, as the daemon's 8
        # receiving connection threads do: between the start event and the
        # launch the card waits for the host.
        gap_ms = {}
        stop = threading.Event()

        def gil_holder():
            buf = bytearray(16 << 20)
            while not stop.is_set():
                bytes(buf)  # a 16 MiB copy under the GIL, as a frame's bytes() is

        with config.option("device_timing", True):
            kernels.gram_colsum(xb, DP_ROWS, st)
            for tag, gap, busy in (("back to back", 0.0, 0), ("each after 0.5 s idle", 0.5, 0),
                                   ("beside 8 threads copying under the GIL", 0.01, 8)):
                holders = [threading.Thread(target=gil_holder) for _ in range(busy)]
                for th in holders:
                    th.start()
                try:
                    g0 = xprof.snapshot()["gram_colsum"]
                    for _ in range(5):
                        time.sleep(gap)
                        kernels.gram_colsum(xb, DP_ROWS, st)
                    g1 = xprof.snapshot()["gram_colsum"]
                finally:
                    stop.set()
                    for th in holders:
                        th.join()
                    stop.clear()
                gap_ms[tag] = ((g1["execute_s"] - g0["execute_s"])
                               / (g1["execute_calls"] - g0["execute_calls"]) * 1e3)
        del xb, st
        print("phase 30a the same gram_colsum launch in this process (CUDA events, device_timing): "
              + ", ".join(f"{tag} {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s)"
                          for tag, ms in gap_ms.items()), flush=True)
        out["gram_colsum"] = launches
        del model, arrays
        torch.cuda.empty_cache()

        # -- b. served exact kNN through the scheduler, the ring armed ------------
        metrics_mod.reset()  # the SLO history and the exemplars start here
        with config.option("telemetry_trace_buffer", 0), \
                config.option("telemetry_eval_interval_s", P30_TICK_S), \
                config.option("slo_objectives", P30_SLO):
            served = DataPlaneDaemon(device=DEV).start()
        try:
            served._flight.state_dir = tmp.name  # where its incident bundles go
            gen = torch.Generator(device=DEV).manual_seed(P30_SEED)
            centers = torch.randn((KNN_CLUSTERS, KNN_D), generator=gen, device=DEV)
            x = knn_data(torch, gen, KNN_ROWS, centers)
            nn = NearestNeighbors().setK(KNN_K).fit({"features": x})
            del x, centers
            with served._models_lock:
                served._models["p30-exact"] = daemon_mod._ServedModel.from_model(
                    "knn", nn, buckets=served._buckets)
            with DataPlaneClient(*served.address) as c:
                ack = c.warmup("p30-exact", n_cols=KNN_D, k=KNN_K)
            check(ack["compiled"] == len(served._buckets),
                  f"phase 30b warmup: {ack}")
            clients.collect("ready")
            journal.ring_arm(int(config.get("telemetry_trace_buffer")))
            ring_held = True
            breach0 = p29_metric(metrics_mod.snapshot(), "srml_slo_breach",
                                 objective="kneighbors:p99_ms")
            # -- c. the SLO breach: the first kneighbors traffic, unmeasured ----
            p30_traffic(torch, kernels, clients, "warm", served.address,
                        "exact kNN, the first traffic (ring armed, rate not compared)")
            t_end = time.perf_counter()
            while True:
                snap = metrics_mod.snapshot()
                breach = p29_metric(snap, "srml_slo_breach", objective="kneighbors:p99_ms")
                waited = time.perf_counter() - t_end
                if breach >= 1.0 or waited > 2 * P30_TICK_S + 0.25:
                    break
                time.sleep(0.01)
            check(breach0 == 0.0 and breach == 1.0,
                  f"phase 30c srml_slo_breach{{objective=kneighbors:p99_ms}} {breach0} before "
                  f"any kneighbors request, {breach} == 1 within two ticks of the first "
                  f"traffic ({waited:.3f} s after it, ticks of {P30_TICK_S} s)")
            warm_b = p29_metric(snap, "srml_scheduler_batches_total", op="kneighbors")
            # -- b. the measured traffic -----------------------------------------
            led0 = xprof.snapshot().get("dist_topk", {}).get("calls", 0)
            rates = {"ring": [], "off": [], "file": []}
            r, lt, rt = p30_traffic(torch, kernels, clients, "ring", served.address,
                                    "exact kNN, ring armed")
            rates["ring"].append(r)
            n_req = P29_PROCS * P30_REQS
            deadline = time.monotonic() + 10.0
            while True:  # a request counts once its answer is on the wire
                snap = metrics_mod.snapshot()
                if (p29_metric(snap, "srml_daemon_requests_total", op="kneighbors") >= 2 * n_req
                        or time.monotonic() > deadline):
                    break
                time.sleep(0.01)
            batches = p29_metric(snap, "srml_scheduler_batches_total", op="kneighbors") - warm_b
            led = xprof.snapshot()["dist_topk"]["calls"] - led0
            check(led == lt["dist_topk"] == batches == rt["dist_topk/wgmma"] and 0 < batches,
                  f"phase 30b kernel ledger: dist_topk calls {led} == LAUNCHES "
                  f"{lt['dist_topk']} == srml_scheduler_batches_total{{op=kneighbors}} "
                  f"{int(batches)}, all wgmma, for {n_req} requests")
            out["dist_topk"] = lt["dist_topk"]
            with DataPlaneClient(*served.address) as c:
                pull = c.telemetry_pull()
                traced = c.trace_pull(0)
            lat = pull["metrics"]["srml_daemon_request_seconds"]["samples"]
            exemplars = [ex for sm in lat if sm["labels"].get("op") == "kneighbors"
                         for ex in (sm.get("exemplars") or {}).values()]
            ids = p30_span_ids(traced["events"])
            check(exemplars and all(ex["span"] in ids for ex in exemplars)
                  and pull["text"].rstrip().endswith("# EOF")
                  and pull["fingerprint"] == config.fingerprint()
                  and pull["xprof"]["dist_topk"]["calls"] >= led,
                  f"phase 30b telemetry_pull: {len(exemplars)} kneighbors exemplars of "
                  f"srml_daemon_request_seconds, each naming a span trace_pull returns "
                  f"({len(traced['events'])} events); OpenMetrics text, fingerprint, kernel "
                  f"ledger")

            # -- c. the incident bundle the breach wrote -------------------------
            inc_dir = os.path.join(tmp.name, "incidents")
            deadline = time.monotonic() + 5.0
            found = []
            while not found and time.monotonic() < deadline:
                if os.path.isdir(inc_dir):
                    found = sorted(f for f in os.listdir(inc_dir)
                                   if "slo_breach" in f and f.endswith(".json"))
                time.sleep(0.02)
            check(bool(found), f"phase 30c the telemetry thread wrote an slo_breach bundle "
                               f"under the recorder's state_dir: {found}")
            bundle = flight.load_bundle(os.path.join(inc_dir, found[0]))
            bx = bundle["xprof"]
            check(bundle["reason"] == "slo_breach" and bundle["events"]
                  and bundle["identity"]["boot_id"] == served.boot_id
                  and bx.get("gram_colsum", {}).get("calls", 0) >= folded
                  and bx.get("dist_topk", {}).get("calls", 0) > 0,
                  f"phase 30c load_bundle: reason {bundle['reason']}, {len(bundle['events'])} "
                  f"events, the ledger's gram_colsum {bx.get('gram_colsum', {}).get('calls')} "
                  f"and dist_topk {bx.get('dist_topk', {}).get('calls')} calls")

            # -- d. the journal's cost a served request --------------------------
            for rnd in range(2):
                journal.ring_disarm()
                ring_held = False
                r, _, _ = p30_traffic(torch, kernels, clients, f"off{rnd}", served.address,
                                      f"exact kNN, journal off (round {rnd + 1})")
                rates["off"].append(r)
                journal.ring_arm(int(config.get("telemetry_trace_buffer")))
                ring_held = True
                r, _, _ = p30_traffic(torch, kernels, clients, f"ring{rnd + 1}", served.address,
                                      f"exact kNN, ring armed (round {rnd + 1})")
                rates["ring"].append(r)
                with config.option("run_journal", os.path.join(tmp.name, "journal.jsonl")):
                    r, _, _ = p30_traffic(torch, kernels, clients, f"file{rnd}",
                                          served.address,
                                          f"exact kNN, ring armed and a journal file (round "
                                          f"{rnd + 1})")
                rates["file"].append(r)
                journal.close()
            lines = len(journal.read(os.path.join(tmp.name, "journal.jsonl")))
            for a, b in (("warm", "off0"), ("ring", "off0"), ("ring1", "off0"),
                         ("file0", "off0"), ("ring2", "off1"), ("file1", "off1")):
                bad = clients.all("compare", a, b)
                n_bad = sum(len(x["bad"]) for x in bad)
                check(n_bad == 0, f"phase 30d answers of run {a} bitwise those of {b} "
                                  f"({n_bad} of {n_req} differ)")
            print("phase 30d requests/s: " + "; ".join(
                f"{k} {', '.join(f'{v:.1f}' for v in vs)}" for k, vs in rates.items())
                + f" ({lines} journal lines written)", flush=True)

            # -- the ledger's cost a launch, the journal's a span ------------------
            qs1 = torch.randn((1, KNN_D), generator=gen, device=DEV).to(torch.bfloat16)
            rows = torch.randn((65536, KNN_D), generator=gen, device=DEV).to(torch.bfloat16)
            ids_r = torch.arange(65536, dtype=torch.int32, device=DEV)
            ones = torch.ones(65536, device=DEV)

            q_sig = (qs1, rows, KNN_K)
            work = (2 * 65536 * KNN_D, (1 + 65536) * KNN_D * 2 + 8 * 65536 + 8 * KNN_K)

            def records(n):
                t0 = time.perf_counter()
                for _ in range(n):
                    with kernels._ledger("phase30.ledger_probe", "wgmma", qs1.device, *work,
                                         *q_sig):
                        pass
                return (time.perf_counter() - t0) / n * 1e6

            rec_us = records(P30_SPANS)
            with config.option("metrics", False):
                pass_us = records(P30_SPANS)
            print(f"phase 30 the kernel ledger's record alone: {rec_us:.2f} µs a call "
                  f"(dist_topk's arguments, timing off), {pass_us:.2f} µs with metrics off "
                  f"(the passthrough); host clock, {P30_SPANS} records", flush=True)

            def block(on):
                with config.option("metrics", on):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(P30_MICRO_CALLS):
                        kernels.dist_topk(qs1, rows, ids_r, ones, KNN_K)
                    torch.cuda.synchronize()
                    return (time.perf_counter() - t0) / P30_MICRO_CALLS * 1e6

            block(True)
            us = {False: [], True: []}
            for on in (False, True, True, False):
                us[on].append(block(on))
            print(f"phase 30 the kernel ledger's cost: dist_topk (1 x 65,536 x {KNN_D} bf16, "
                  f"k = {KNN_K}) {', '.join(f'{v:.2f}' for v in us[True])} µs a call ledger "
                  f"on, {', '.join(f'{v:.2f}' for v in us[False])} off (host clock over "
                  f"{P30_MICRO_CALLS} calls, synced; timing off)", flush=True)

            def spans(n):
                t0 = time.perf_counter()
                for _ in range(n):
                    with journal.span("phase30"):
                        pass
                return (time.perf_counter() - t0) / n * 1e6

            armed_us = spans(P30_SPANS)
            journal.ring_disarm()
            ring_held = False
            off_us = spans(P30_SPANS)
            print(f"phase 30 the journal's cost: {armed_us:.2f} µs a span with the ring armed, "
                  f"{off_us:.2f} µs off (host clock, {P30_SPANS} spans)", flush=True)
        finally:
            served.stop()
    finally:
        if ring_held:
            journal.ring_disarm()
        journal.close()
        clients.close()
        tmp.cleanup()
    torch.cuda.empty_cache()
    print(f"phase 30: {time.perf_counter() - t_phase:.1f} s; telemetry_launches {out}",
          flush=True)
    return out


P31_SEED = 31
#: Phase 31a's frames (run → the P21_RUNS fields): phase 21's KMeans width,
#: cut to one 32,768-row frame a partition (262,144 rows) for the smoke's
#: time, phase 28's integer blobs (every sum exact, so a restarted fit is
#: bitwise the clean one).
P31_RUNS = {"kmeans-int": ("kmeans", KM_D, DP_ROWS // 2, 1, KM_K)}
#: Phase 31b's knn frames: phase 22's rows cut to one half-size frame a
#: partition (262,144 x 768), so the snapshots and restores fit the
#: smoke's time.
P31_KNN_RUNS = {"knn": ("knn", KNN_D, DP_ROWS // 2, 1, KNN_CLUSTERS)}
P31_MAX_ITER = 3
#: The daemon of 31a's faulted fit crashes at the second step's boundary
#: (the step that closes pass 1), after its snapshot, before its ack.
P31_CRASH = f"seed={P31_SEED};daemon.pass_boundary:crash:after=1,times=1"
P31_FLEET_ROWS = 1 << 18  # 262,144 x 768 f32: one 0.75 GiB ensure_model frame
P31_THREADS, P31_REQS, P31_AFTER_REQS = 8, 64, 8
P31_TRANSFORM_ROWS, P31_QUERIES = 64, 16
P31_INPUTS = 32  # distinct transform inputs and query sets the requests cycle through
P31_GOSSIP_S = 0.2
P31_DAEMON_TIMEOUT_S = 300  # a daemon process's time to come up
P31_VICTIM = 1  # 31c's replica SIGKILLed mid-traffic (the seed is replica 0)


def _p31_daemon(cmd_q, out_q, device, kw, plan):
    """Phase 31's daemon process: one port daemon on ``device`` with the
    keyword arguments ``kw`` (port, state_dir, gossip, batching). ``plan``
    arms ``SRML_TORCH_FAULT_PLAN`` before the port is imported, its crash
    rule SIGKILLing this process. Answers "launches" with its counters and
    "stop" by stopping."""
    import signal

    try:
        if plan:
            os.environ["SRML_TORCH_FAULT_PLAN"] = plan
        from spark_rapids_ml_tpu_torch.ops import kernels
        from spark_rapids_ml_tpu_torch.serve import DataPlaneDaemon
        from spark_rapids_ml_tpu_torch.utils import faults

        if plan:
            faults.active_plan().on_crash(lambda: os.kill(os.getpid(), signal.SIGKILL))
        daemon = DataPlaneDaemon(host="127.0.0.1", device=device, **kw).start()
    except Exception as e:  # noqa: BLE001 - reported to the parent
        out_q.put(("err", repr(e)))
        return
    out_q.put(("ready", daemon.address[1], daemon.instance_id, daemon.boot_id))
    while True:
        cmd = cmd_q.get()
        if cmd == "launches":
            out_q.put(("launches", dict(kernels.LAUNCHES), dict(kernels.ROUTES)))
        elif cmd == "reset":
            kernels.reset_launches()
            out_q.put(("reset",))
        elif cmd == "stop":
            daemon.stop()
            out_q.put(("stopped",))
            return


class _P31Daemon:
    """One phase-31 daemon process: spawned (never forked: the parent holds a
    CUDA context), restartable on its port and ``state_dir`` after a death.
    Each incarnation gets queues of its own: a SIGKILLed process may die
    holding a queue's lock."""

    def __init__(self, ctx, device, plan=None, **kw):
        self.ctx, self.device, self.kw = ctx, device, dict(kw)
        self.spawn(plan)

    def spawn(self, plan=None):
        self.cmd, self.out = self.ctx.Queue(), self.ctx.Queue()
        self.proc = self.ctx.Process(target=_p31_daemon, daemon=True,
                                     args=(self.cmd, self.out, self.device, self.kw, plan))
        self.proc.start()

    def ready(self):
        msg = self.out.get(timeout=P31_DAEMON_TIMEOUT_S)
        if msg[0] != "ready":
            fail(f"phase 31: a daemon process failed to start: {msg}")
        _, port, self.instance_id, self.boot_id = msg
        self.kw["port"] = port  # a restart binds the same port
        return self

    @property
    def address(self):
        return ("127.0.0.1", self.kw["port"])

    def launches(self):
        self.cmd.put("launches")
        _, launches, routes = self.out.get(timeout=120)
        return launches, routes

    def reset(self):
        """Zero the process's launch and route counters."""
        self.cmd.put("reset")
        self.out.get(timeout=120)

    def kill(self):
        """SIGKILL; the exit code (-9)."""
        self.proc.kill()
        self.proc.join(timeout=60)
        return self.proc.exitcode

    def stop(self):
        if self.proc.is_alive():
            self.cmd.put("stop")
            try:
                self.out.get(timeout=120)
            except Exception:  # noqa: BLE001 - terminated below
                pass
            self.proc.join(timeout=30)
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join(timeout=10)


def p31_metrics(address):
    from spark_rapids_ml_tpu_torch.serve import DataPlaneClient

    with DataPlaneClient(*address) as c:
        return c.metrics()


def p31_snapshot_ms(snap):
    """(seconds, count) of a daemon's "daemon snapshot write" spans."""
    labels = {"phase": "daemon snapshot write"}
    return (p29_metric(snap, "srml_phase_duration_seconds", "sum", **labels),
            p29_metric(snap, "srml_phase_duration_seconds", "count", **labels))


def p31_kmeans(est, pool, daemon, tag, watch=None):
    """One 31a fit: ``_drive_kmeans`` over ``daemon`` with every partition
    routed to it, the recovery ledger armed and a client that waits out a
    restart. ``watch(pass_id)`` runs before each scan. Returns (model, a
    record: scan starts, seconds)."""
    import numpy as np

    from spark_rapids_ml_tpu_torch import KMeans

    job = f"phase31-kmeans-{tag}"
    fit = est._DaemonFit(*daemon.address, job, recovery_attempts=2, timeout=900.0,
                         op_deadline_s=240.0, max_op_attempts=100_000)
    rec = {"starts": []}
    route = {p: daemon.address for p in range(DP_PARTITIONS)}

    def run_pass(pass_id):
        rec["starts"].append((pass_id, time.perf_counter()))
        if watch is not None:
            watch(pass_id)
        return pool.scan("kmeans-int", job, fit.params, pass_id, dies=False, route=route)

    sample = p21_frame(np, P31_RUNS, "kmeans-int", 0, 0)[0][:est._kmeans_seed_rows(KM_K)]
    core = KMeans(device=DEV).setK(KM_K).setMaxIter(P31_MAX_ITER).setTol(0.0).setSeed(P31_SEED)
    t0 = time.perf_counter()
    try:
        model = est._drive_kmeans(fit, run_pass, core, sample)
    finally:
        fit.close()
    rec["s"] = time.perf_counter() - t0
    rec["acked"] = fit.total_fed
    return model, rec


def p31_durable_fit(np, est, pool, clean, doomed):
    """31a: the clean fit, then the faulted fit with its daemon's death and
    restart; their checks and numbers."""
    import threading

    n = DP_PARTITIONS * P31_RUNS["kmeans-int"][3] * P31_RUNS["kmeans-int"][2]
    clean.ready()
    doomed.ready()
    pool.prepare("kmeans-int")
    boundaries = []
    last = [p31_snapshot_ms(p31_metrics(clean.address))]
    job_file = []

    def watch(pass_id):
        # Each scan starts after a boundary (the seed, then each step): its
        # snapshot's seconds from the daemon's spans, its bytes on disk.
        cur = p31_snapshot_ms(p31_metrics(clean.address))
        files = [f for f in os.listdir(clean.kw["state_dir"]) if f.startswith("job-")]
        size = os.path.getsize(os.path.join(clean.kw["state_dir"], files[0])) if files else 0
        job_file[:] = files
        boundaries.append((pass_id, (cur[0] - last[0][0]) * 1e3, cur[1] - last[0][1], size))
        last[0] = cur

    ref, rc = p31_kmeans(est, pool, clean, "clean", watch)
    check(len(job_file) == 1 and not any(f.startswith("job-")
                                         for f in os.listdir(clean.kw["state_dir"])),
          "phase 31a clean fit: one job snapshot during the fit, deleted by its finalize")
    clean.stop()
    for pass_id, ms, count, size in boundaries:
        print(f"phase 31a snapshot at the boundary opening scan {pass_id}: {size} bytes, "
              f"{ms:.3f} ms ({count:.0f} write)", flush=True)
    check(all(c == 1 for _, _, c, _ in boundaries) and all(s > 0 for *_, s in boundaries),
          f"phase 31a: one snapshot write at each of the {len(boundaries)} boundaries")

    # The faulted fit: its daemon dies at the boundary closing pass 1; a
    # monitor restarts it on the same port and state_dir.
    marks = {}

    def monitor():
        while doomed.proc.exitcode is None:
            time.sleep(0.005)
        marks["death"] = time.perf_counter()
        marks["code"] = doomed.proc.exitcode
        doomed.spawn()
        doomed.ready()
        marks["up"] = time.perf_counter()

    old_id, old_boot = doomed.instance_id, doomed.boot_id
    mon = threading.Thread(target=monitor, daemon=True)
    mon.start()
    got, rf = p31_kmeans(est, pool, doomed, "fault")
    mon.join(timeout=60)
    snap = p31_metrics(doomed.address)
    restores = p29_metric(snap, "srml_daemon_job_restores_total", algo="kmeans")
    replay = [t for pid, t in rf["starts"] if pid == 1 and t > marks.get("death", 1e30)]
    check(marks.get("code") == -9 and doomed.instance_id == old_id
          and doomed.boot_id != old_boot and restores == 1,
          f"phase 31a: the daemon died by SIGKILL at the pass boundary (exit "
          f"{marks.get('code')}), restarted with its instance id {doomed.instance_id} "
          f"(was {old_id}) and a new boot id ({old_boot} -> {doomed.boot_id}); "
          f"srml_daemon_job_restores_total {restores:.0f} == 1")
    # The dead incarnation's pass-1 rows were folded into the snapshot's row
    # count, and the replay folds them again: one scan more than the clean fit.
    check(bool(replay) and len(rf["starts"]) == len(rc["starts"]) + 1
          and rf["acked"] == rc["acked"] + n and got.summary.numIter == ref.summary.numIter >= 2,
          f"phase 31a: pass 1 replayed after the death ({len(rf['starts'])} scans of {n} rows "
          f"against the clean fit's {len(rc['starts'])}); {rf['acked']} rows acked == "
          f"{rc['acked']} + {n}; numIter {got.summary.numIter} == {ref.summary.numIter}")
    cost = abs(got.summary.trainingCost - ref.summary.trainingCost) / ref.summary.trainingCost
    # Integer rows: every centre sum is exact, so the centres are bitwise;
    # the cost sums ‖x‖² + ‖c‖² − 2x·c at non-integer centres in f32, in
    # the commit order (phase 28's 1e-6).
    check(np.array_equal(np.asarray(got.centers), np.asarray(ref.centers)) and cost <= 1e-6,
          f"phase 31a: the restarted fit's centres bitwise the clean fit's; cost rel err "
          f"{cost:.3e} (tol 1e-6)")
    print(f"phase 31a: clean fit {rc['s']:.3f} s, faulted fit {rf['s']:.3f} s; death to the "
          f"restarted daemon's ready {marks['up'] - marks['death']:.3f} s, death to the "
          f"replay's scan {replay[0] - marks['death']:.3f} s", flush=True)
    doomed.stop()


def p31_knn_fit(est, pool, daemon, core, tag):
    """One 31b knn fit into ``daemon``: (the _DaemonKNNModel, finalize seconds)."""
    job = f"phase31-{tag}"
    fit = est._DaemonFit(*daemon.address, job, timeout=900.0)
    route = {p: daemon.address for p in range(DP_PARTITIONS)}
    rec = {}
    finalize_knn = fit.client.finalize_knn

    def timed(*a, **kw):
        t0 = time.perf_counter()
        out = finalize_knn(*a, **kw)
        rec["s"] = time.perf_counter() - t0
        return out

    fit.client.finalize_knn = timed
    try:
        model = est._drive_knn(fit, lambda pid: pool.scan("knn", job, {}, pid, dies=False,
                                                           route=route), core)
    finally:
        fit.close()
    return model, rec["s"]


def p31_durable_index(np, est, pool, daemon):
    """31b: the IVF and exact indexes built, killed, restored; their launches
    over both incarnations ({kernel: n})."""
    from spark_rapids_ml_tpu_torch import ApproximateNearestNeighbors, NearestNeighbors
    from spark_rapids_ml_tpu_torch.serve import DataPlaneClient

    sdir = daemon.kw["state_dir"]
    daemon.ready()
    qs = knn_frame(np, DP_PARTITIONS, 0, KNN_QUERIES, KNN_D, KNN_CLUSTERS)
    pool.prepare("knn")
    snap0 = p31_snapshot_ms(p31_metrics(daemon.address))
    core = (ApproximateNearestNeighbors(device=DEV).setK(KNN_K).setNlist(KNN_NLIST)
            .setNprobe(KNN_NPROBE))
    amodel, a_s = p31_knn_fit(est, pool, daemon, core, "ivf")
    snap1 = p31_snapshot_ms(p31_metrics(daemon.address))
    emodel, e_s = p31_knn_fit(est, pool, daemon, NearestNeighbors(device=DEV).setK(KNN_K),
                              "exact")
    snap2 = p31_snapshot_ms(p31_metrics(daemon.address))
    sizes = {name: os.path.getsize(os.path.join(sdir, name))
             for name in os.listdir(sdir) if name.startswith("model-")}
    print(f"phase 31b finalize (build + snapshot + ack): ivf {a_s:.3f} s, exact {e_s:.3f} s; "
          f"snapshot writes ivf {snap1[0] - snap0[0]:.3f} s, exact {snap2[0] - snap1[0]:.3f} s; "
          f"bytes {sorted(sizes.values())} (total {sum(sizes.values()) / 2**30:.2f} GiB)",
          flush=True)
    check(len(sizes) == 2 and snap2[1] - snap0[1] == 2,
          f"phase 31b: two index snapshots written at the finalizes ({sorted(sizes)})")
    before = {}
    for tag, m in (("ivf", amodel), ("exact", emodel)):
        t0 = time.perf_counter()
        before[tag] = m.kneighbors(qs)
        print(f"phase 31b {tag} kneighbors before the kill: {time.perf_counter() - t0:.3f} s "
              f"for {KNN_QUERIES} queries (the first call: the index upload)", flush=True)
    pre, pre_r = daemon.launches()
    code = daemon.kill()
    t_kill = time.perf_counter()
    daemon.spawn()
    daemon.ready()
    print(f"phase 31b: SIGKILLed (exit {code}); the restarted process ready in "
          f"{time.perf_counter() - t_kill:.3f} s", flush=True)
    with DataPlaneClient(*daemon.address) as c:
        lazy = c.health()["served_models"]
    for tag, m in (("ivf", amodel), ("exact", emodel)):
        t0 = time.perf_counter()
        d, i = m.kneighbors(qs)
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        m.kneighbors(qs)
        warm = time.perf_counter() - t0
        check(np.array_equal(d, before[tag][0]) and np.array_equal(i, before[tag][1]),
              f"phase 31b {tag}: the answers after the restart bitwise equal to the answers "
              f"before the kill ({KNN_QUERIES} queries, k = {KNN_K})")
        print(f"phase 31b {tag}: first kneighbors after the restart (the lazy restore, the "
              f"upload, the query) {first:.3f} s; warm {warm:.3f} s = "
              f"{KNN_QUERIES / warm:.1f} q/s", flush=True)
    post, post_r = daemon.launches()
    restore_s = p29_metric(p31_metrics(daemon.address), "srml_phase_duration_seconds", "sum",
                           phase="daemon restore")
    print(f"phase 31b: restore spans {restore_s:.3f} s in all; launches before the kill "
          f"{pre} (routes {pre_r}); after the restart {post} (routes {post_r})", flush=True)
    check(code == -9 and lazy == 0,
          f"phase 31b: the daemon died by SIGKILL (exit {code}) and its successor held no "
          f"model until one was named ({lazy} served)")
    check(pre["lloyd_step"] == pre_r["lloyd_step/wgmma"] == 10
          and pre["assign_min_dist"] >= 2 and pre_r["assign_min_dist/wgmma"] == 1
          and pre_r["dist_topk/wgmma"] == 1
          and pre["probe_select"] == pre_r["probe_select/fused"] == 1
          and pre["ivf_scan_select"] == pre_r["ivf_scan_select/wgmma"] == 1,
          f"phase 31b, the first incarnation: the IVF build's lloyd_step (10, wgmma), "
          f"assign_min_dist (1 wgmma + the f32 chunks) and {pre_r['dist_topk/ffma']} f32 "
          f"dist_topk spill-candidate launches (ffma, where a list outgrew its cap); one "
          f"fused probe_select, one wgmma ivf_scan_select and one wgmma dist_topk for the two "
          f"calls")
    check(post["probe_select"] == post_r["probe_select/fused"] == 2
          and post["ivf_scan_select"] == post_r["ivf_scan_select/wgmma"] == 2
          and post["dist_topk"] == post_r["dist_topk/wgmma"] == 2
          and post["lloyd_step"] == post["assign_min_dist"] == 0,
          "phase 31b, the restarted incarnation: the restored indexes answer through "
          "probe_select (fused), ivf_scan_select and dist_topk (wgmma), one launch a call, "
          "and rebuild nothing")
    daemon.stop()
    names = ("lloyd_step", "assign_min_dist", "dist_topk", "probe_select", "ivf_scan_select")
    return {k: pre.get(k, 0) + post.get(k, 0) for k in names}


def p31_views(addrs):
    from spark_rapids_ml_tpu_torch.serve import DataPlaneClient

    out = []
    for a in addrs:
        with DataPlaneClient(*a, timeout=5.0, max_op_attempts=1) as c:
            out.append(c.gossip_pull())
    return out


def p31_converged(addrs, want_replicas, timeout_s=30.0):
    """Seconds until every daemon's view holds the same replicas and models,
    ``want_replicas`` of them live; None past the timeout."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout_s:
        try:
            views = p31_views(addrs)
        except Exception:  # noqa: BLE001 - a daemon still starting
            views = None
        if views and all(v.get("replicas") == views[0].get("replicas")
                         and v.get("models") == views[0].get("models") for v in views) \
                and sum(r["liveness"] == "up"
                        for r in views[0]["replicas"].values()) == want_replicas:
            return time.perf_counter() - t0
        time.sleep(0.02)
    return None


def p31_fleet(torch, np, reps):
    """31c: the routed fleet over the replica processes ``reps``; its
    dist_topk launches over them."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from spark_rapids_ml_tpu_torch import PCA
    from spark_rapids_ml_tpu_torch.serve import DataPlaneClient, FleetClient, FleetView
    from spark_rapids_ml_tpu_torch.serve import RoutingTable
    from spark_rapids_ml_tpu_torch.utils import metrics as metrics_mod

    # The models while the replicas come up: PCA v1 and v2 at phase 3's
    # width (and phase 32's third set of components), the index rows the
    # first quarter of phase 22's.
    gen = torch.Generator(device=DEV).manual_seed(P31_SEED)
    pcas = []
    for v in (1, 2, 3):
        x = torch.randn((1 << 16, D), generator=gen, device=DEV) * (1.0 + v)
        m = PCA(device=DEV).setK(K).fit({"features": x})
        pcas.append({k: np.asarray(torch.as_tensor(a).cpu()) for k, a in m._model_data().items()})
    keys = [(p, f) for p in range(DP_PARTITIONS) for f in range(DP_FEEDS)]
    keys = keys[:P31_FLEET_ROWS // DP_ROWS]
    rows = np.empty((P31_FLEET_ROWS, KNN_D), np.float32)

    def fill(i):
        rows[i * DP_ROWS:(i + 1) * DP_ROWS] = knn_frame(np, *keys[i], DP_ROWS, KNN_D,
                                                        KNN_CLUSTERS)

    with ThreadPoolExecutor(max_workers=8) as ex:
        list(ex.map(fill, range(len(keys))))
    rng = np.random.default_rng(P31_SEED)
    xs = [rng.standard_normal((P31_TRANSFORM_ROWS, D), dtype=np.float32)
          for _ in range(P31_INPUTS)]
    qs = [knn_frame(np, DP_PARTITIONS, 1 + i, P31_QUERIES, KNN_D, KNN_CLUSTERS)
          for i in range(P31_INPUTS)]
    for r in reps:
        r.ready()
    addrs = [r.address for r in reps]
    keyed = ["%s:%d" % a for a in addrs]
    t0 = time.perf_counter()
    knn_arrays, knn_params = {"database": rows}, {"k": KNN_K}

    def register(a):
        with DataPlaneClient(*a, timeout=600.0) as c:
            c.ensure_model("pca@v1", "pca", pcas[0], version=1)
            c.ensure_model("pca@v2", "pca", pcas[1], version=2)
            c.ensure_model("knn@v1", "knn", knn_arrays, params=knn_params, version=1)

    with ThreadPoolExecutor(max_workers=len(addrs)) as ex:
        list(ex.map(register, addrs))
    print(f"phase 31c: PCA v1, v2 and the {P31_FLEET_ROWS} x {KNN_D} exact index registered "
          f"on 3 replicas in {time.perf_counter() - t0:.3f} s", flush=True)
    table = RoutingTable(keyed)
    table.install("pca", 1, "pca", pcas[0])
    table.activate("pca", 1)
    table.install("pca", 2, "pca", pcas[1])
    epoch = table.activate("pca", 2)
    table.install("knn", 1, "knn", knn_arrays, knn_params)
    table.activate("knn", 1)
    view = FleetView()
    for v in p31_views(addrs):
        view.merge(v)
    view.set_model("pca", 2, epoch, boot_id="phase31", tombstone_versions=())
    view.set_model("knn", 1, 1, boot_id="phase31")
    with DataPlaneClient(*addrs[0]) as c:
        c.gossip_push(view.to_wire())  # one daemon; the rest by gossip
    conv0 = p31_converged(addrs, 3)
    check(conv0 is not None, f"phase 31c: the pushed view converged on all three daemons "
                             f"({conv0})")
    # The single daemon's answers, and the fence.
    with DataPlaneClient(*addrs[0]) as c:
        want_t = [c.transform_raw("pca@v2", x)["output"] for x in xs]
        want_k = [c.kneighbors_raw("knn@v1", q, k=KNN_K) for q in qs]
        _, meta = c.transform_raw("pca@v2", xs[0], version=2, fleet_epoch=epoch, with_meta=True)
        try:
            c.transform_raw("pca@v2", xs[0], version=1, fleet_epoch=epoch)
            refused = ""
        except RuntimeError as e:
            refused = str(e)
    check(meta.get("version") == 2 and meta.get("fleet_epoch") == epoch
          and "version mismatch" in refused,
          f"phase 31c: the held version echoed ({meta}); version 1 of pca@v2 refused: "
          f"{refused[:120]}")
    seed = keyed[0]

    def counters():
        snap = metrics_mod.snapshot()
        return {"failovers": {r: p29_metric(snap, "srml_router_failovers_total", reason=r)
                              for r in ("busy", "dead", "error")},
                "repairs": p29_metric(snap, "srml_router_repairs_total"),
                "resyncs": p29_metric(snap, "srml_fleet_bootstraps_total", outcome="resync")}

    kw = {"client_kwargs": {"timeout": 120.0, "op_deadline_s": 240.0}}
    clients = [FleetClient(table, **kw) if t < P31_THREADS // 2
               else FleetClient.from_seeds(seed, **kw) for t in range(P31_THREADS)]
    victim = reps[P31_VICTIM]
    victim_key = next(f"v{i}" for i in range(10000)
                      if table.ring.primary(f"v{i}") == keyed[P31_VICTIM])
    lat, bad, done = [], [], [0]
    lock = threading.Lock()

    def worker(t, n, sticky):
        fc = clients[t]
        for i in range(n):
            j = (t * 7 + i) % P31_INPUTS
            key = sticky if i % 2 == 0 else None
            t0 = time.perf_counter()
            try:
                if (t + i) % 2 == 0:
                    out = fc.transform("pca", xs[j], route_key=key)["output"]
                    ok = np.array_equal(out, want_t[j])
                else:
                    d, ix = fc.kneighbors("knn", qs[j], k=KNN_K, route_key=key)
                    ok = np.array_equal(d, want_k[j][0]) and np.array_equal(ix, want_k[j][1])
            except Exception as e:  # noqa: BLE001 - counted, the check fails
                ok = f"{type(e).__name__}: {e}"
            with lock:
                lat.append(time.perf_counter() - t0)
                done[0] += 1
                if ok is not True:
                    bad.append((t, i, ok))

    def traffic(n, sticky_of, kill_at=None):
        marks = {}

        def killer():
            while done[0] < kill_at:
                time.sleep(0.001)
            marks["launches"] = victim.launches()
            marks["code"] = victim.kill()
            marks["kill"] = time.perf_counter()

        threads = [threading.Thread(target=worker, args=(t, n, sticky_of(t)))
                   for t in range(P31_THREADS)]
        k = threading.Thread(target=killer) if kill_at is not None else None
        t0 = time.perf_counter()
        for th in threads + ([k] if k else []):
            th.start()
        for th in threads + ([k] if k else []):
            th.join()
        return time.perf_counter() - t0, marks

    base = counters()
    n1 = P31_THREADS * P31_REQS
    wall, marks = traffic(P31_REQS, lambda t: f"user-{t % 4}", kill_at=n1 // 4)
    lat1 = sorted(lat)
    mid = counters()
    victim.spawn()
    victim.ready()
    up = time.perf_counter()
    conv1 = p31_converged(addrs, 3)
    del lat[:]
    # Two hand-built-table clients keyed to the restarted replica (a
    # transform and a kneighbors thread), the rest free keys.
    wall2, _ = traffic(P31_AFTER_REQS, lambda t: victim_key if t < 2 else None)
    end = counters()
    n2 = P31_THREADS * P31_AFTER_REQS
    with DataPlaneClient(*victim.address) as c:
        repaired = [c.model_exists(name) for name in ("pca@v2", "knn@v1")]
    p50, p99 = lat1[len(lat1) // 2], lat1[min(len(lat1) - 1, int(0.99 * len(lat1)))]
    print(f"phase 31c: {n1} routed requests in {wall:.3f} s = {n1 / wall:.1f} requests/s, "
          f"p50 {p50 * 1e3:.3f} ms, p99 {p99 * 1e3:.3f} ms (host clock per request); replica "
          f"{keyed[P31_VICTIM]} SIGKILLed (exit {marks.get('code')}) after {n1 // 4} answers; "
          f"failovers {({r: mid['failovers'][r] - base['failovers'][r] for r in mid['failovers']})}"
          f", resyncs {mid['resyncs'] - base['resyncs']:.0f}", flush=True)
    print(f"phase 31c: the replica back in {up - marks['kill']:.3f} s after its kill; views "
          f"converged {conv0:.3f} s after the first push and "
          f"{'never' if conv1 is None else f'{conv1:.3f} s'} after the restart; {n2} more "
          f"requests in {wall2:.3f} s, repairs {end['repairs'] - mid['repairs']:.0f}, "
          f"resyncs {end['resyncs'] - mid['resyncs']:.0f}, failovers "
          f"{({r: end['failovers'][r] - mid['failovers'][r] for r in end['failovers']})}",
          flush=True)
    check(not bad, f"phase 31c: every one of {n1 + n2} routed requests answered bitwise as "
                   f"one daemon answers it ({len(bad)} not: {bad[:3]})")
    check(marks.get("code") == -9 and all(repaired) and end["repairs"] > mid["repairs"]
          and conv1 is not None,
          f"phase 31c: the killed replica (exit {marks.get('code')}), restarted, was "
          f"repaired in band ({repaired}) and the three views converged again")
    for fc in clients:
        fc.close()
    launches = marks["launches"][0].get("dist_topk", 0)
    for r in reps:
        launches += r.launches()[0].get("dist_topk", 0)
    print(f"phase 31c: dist_topk launches over the replicas {launches}", flush=True)
    check(launches >= 1, f"phase 31c: the exact index answered through dist_topk "
                         f"({launches} launches)")
    # The replicas stay up for phase 32, with what it needs of this part.
    served = {"pcas": pcas, "rows": rows, "knn_params": knn_params, "xs": xs, "qs": qs,
              "want_t": want_t, "want_k": want_k}
    return {"dist_topk": launches}, served


P32_SEED = 32
P32_THREADS = 8  # routing threads through a rollout and through the controller deaths
P32_SPIKE = 16  # (c)'s load spike: routing threads sending at once
#: (c)'s watermarks in queued requests per live replica (the routed requests
#: in flight: batching is off, so no scheduler queue), its cooldown and tick.
P32_HIGH, P32_LOW = 1.0, 0.3
P32_COOLDOWN_S, P32_TICK_S = 1.0, 0.2
P32_PERTURB = 0.05  # the index v2: v1's rows + P32_PERTURB · N(0, 1), seeded
P32_WAIT_S = 60.0  # the longest (c) waits for a scale action
P32_CLIENT = {"timeout": 120.0, "op_deadline_s": 240.0}


def _p32_controller(cmd_q, out_q, plan):
    """Phase 32b's controller process: imports only the port under
    ``SRML_TORCH_FAULT_PLAN`` ``plan`` (a crash rule at ``fleet.rollout``
    exits 17), waits for ("go", seed, arrays, version), then rolls PCA to
    ``arrays`` from a fleet bootstrapped from the one seed."""
    try:
        os.environ["SRML_TORCH_FAULT_PLAN"] = plan
        from spark_rapids_ml_tpu_torch.serve import ModelFleet
    except Exception as e:  # noqa: BLE001 - reported to the parent
        out_q.put(("err", repr(e)))
        return
    out_q.put(("ready",))
    _, seed, arrays, version = cmd_q.get()
    with ModelFleet.from_seeds([seed], client_kwargs=P32_CLIENT) as fleet:
        res = fleet.rollout("pca", "pca", arrays, version=version)
    out_q.put(("done", res))


class _P32Traffic:
    """Routing threads, each with its own client ``make_client()``, sending
    64-row PCA transforms and 16-query exact ``kneighbors`` by turns until
    stopped; only threads below ``level`` send. Every answer (or error) is
    kept with its host-clock start and end."""

    def __init__(self, np, make_client, xs, qs, n):
        import threading

        self.np, self.make_client, self.xs, self.qs = np, make_client, xs, qs
        self.level = n
        self.records = [[] for _ in range(n)]
        self._stop = threading.Event()
        self._threads = [threading.Thread(target=self._run, args=(t,)) for t in range(n)]

    def _run(self, t):
        fc = self.make_client()
        try:
            i = 0
            while not self._stop.is_set():
                if t >= self.level:
                    time.sleep(0.005)
                    continue
                j, kind = (t * 7 + i) % P31_INPUTS, "t" if (t + i) % 2 == 0 else "k"
                t0 = time.perf_counter()
                try:
                    if kind == "t":
                        res = fc.transform("pca", self.xs[j])["output"]
                    else:
                        res = fc.kneighbors("knn", self.qs[j], k=KNN_K)
                except Exception as e:  # noqa: BLE001 - counted, the check fails
                    res = f"{type(e).__name__}: {e}"
                self.records[t].append((kind, j, t0, time.perf_counter(), res))
                i += 1
        finally:
            fc.close()

    def start(self):
        for th in self._threads:
            th.start()
        return self

    def stop(self):
        self._stop.set()
        for th in self._threads:
            th.join()

    def window(self, t0, t1):
        """(requests started in [t0, t1), their latencies sorted)."""
        lat = sorted(r[3] - r[2] for rs in self.records for r in rs if t0 <= r[2] < t1)
        return len(lat), lat


def p32_check_answers(np, traffics, gens_t, gens_k):
    """Every answer's version: the one of ``gens_t`` (transforms) or
    ``gens_k`` (kneighbors), solo answers per input, it equals bitwise. A
    thread never goes back a version. Returns the faults (errors, answers
    equal to no version's, steps back) and the answers checked."""
    bad, n = [], 0
    for tag, traffic in traffics:
        for t, recs in enumerate(traffic.records):
            last = {"t": 0, "k": 0}
            for kind, j, _, _, res in recs:
                n += 1
                if isinstance(res, str):
                    bad.append((tag, t, kind, res[:200]))
                    continue
                if kind == "t":
                    hit = [g for g, w in enumerate(gens_t) if np.array_equal(res, w[j])]
                else:
                    hit = [g for g, w in enumerate(gens_k)
                           if np.array_equal(res[0], w[j][0]) and np.array_equal(res[1], w[j][1])]
                if not hit or hit[0] < last[kind]:
                    bad.append((tag, t, kind, "no version's answer" if not hit
                                else f"back from {last[kind]} to {hit[0]}"))
                    continue
                last[kind] = hit[0]
    return bad, n


def p32_solo(addr, model, xs=None, qs=None):
    """A replica's own answers of ``model`` to every input."""
    from spark_rapids_ml_tpu_torch.serve import DataPlaneClient

    with DataPlaneClient(*addr, **P32_CLIENT) as c:
        if xs is not None:
            return [c.transform_raw(model, x)["output"] for x in xs]
        return [c.kneighbors_raw(model, q, k=KNN_K) for q in qs]


def p32_exists(addr, names):
    from spark_rapids_ml_tpu_torch.serve import DataPlaneClient

    with DataPlaneClient(*addr, **P32_CLIENT) as c:
        return {n: c.model_exists(n) for n in names}


def phase_control(torch, np, reps, spare, served):
    """Phase 32, the fleet control plane over phase 31c's replica processes
    ``reps`` and the spare ``spare``: (a) a zero-downtime rollout of PCA and
    of the exact index under routed traffic, (c) the autoscaler scaling out
    onto the spare and back in, (b) a controller process dying mid-rollout,
    twice, and its successor. Returns {"dist_topk": launches}."""
    import contextlib
    import io
    import multiprocessing as mp
    import tempfile

    from spark_rapids_ml_tpu_torch import config
    from spark_rapids_ml_tpu_torch.serve import FleetClient, ModelFleet
    from spark_rapids_ml_tpu_torch.serve.autoscaler import AutoScaler
    from spark_rapids_ml_tpu_torch.tools import top as top_tool
    from spark_rapids_ml_tpu_torch.tools import trace as trace_tool
    from spark_rapids_ml_tpu_torch.utils import journal
    from spark_rapids_ml_tpu_torch.utils import metrics as metrics_mod

    print("phase 32 prediction (NVIDIA H100 80GB HBM3, 700 W, written before the first timed "
          "run): a. the PCA rollout 0.05-0.3 s (registering 0.02-0.1 s, the drain under 0.05 "
          "s), the index rollout 2-6 s (registering 3 x 0.75 GiB), 150-400 requests/s, p99 "
          "30-300 ms during the rollouts; b. a controller's death to its successor's completed "
          "resume 0.1-1 s, to the abort 0.05-0.5 s; c. the scale-up 1-3 s (the index sent to "
          "the newcomer), the scale-down 3-8 s (both models rolled forward on three replicas); "
          "phase 32 40-90 s", flush=True)
    t_phase = time.perf_counter()
    ctx = mp.get_context("spawn")
    xs, qs, pcas = served["xs"], served["qs"], served["pcas"]
    # 32b's controllers import the port while a and c run.
    controllers = []
    for plan in ("fleet.rollout:crash:after=2,times=1", "fleet.rollout:crash:times=1"):
        cq, oq = ctx.Queue(), ctx.Queue()
        proc = ctx.Process(target=_p32_controller, args=(cq, oq, plan), daemon=True)
        proc.start()
        controllers.append((proc, cq, oq))
    spare.ready()
    procs = {"%s:%d" % r.address: r for r in reps + [spare]}
    for r in procs.values():
        r.reset()
    seed = "%s:%d" % reps[0].address
    # The index v2: v1's rows plus a seeded perturbation, so its answers differ.
    gen = torch.Generator(device=DEV).manual_seed(P32_SEED)
    noise = torch.randn(served["rows"].shape, generator=gen, device=DEV) * P32_PERTURB
    rows2 = served["rows"] + noise.cpu().numpy()
    del noise

    # -- a. zero-downtime rollouts under routed traffic -----------------------------------
    fleet = ModelFleet.from_seeds([seed], client_kwargs=P32_CLIENT)
    marks = []
    set_intent = fleet._set_intent

    def timed_intent(model, from_v, to_v, phase):
        marks.append((model, phase, time.perf_counter()))
        set_intent(model, from_v, to_v, phase)

    fleet._set_intent = timed_intent
    traffic_a = _P32Traffic(np, lambda: fleet.client(client_kwargs=P32_CLIENT), xs, qs,
                            P32_THREADS).start()
    time.sleep(0.5)
    t0 = time.perf_counter()
    res_pca = fleet.rollout("pca", "pca", pcas[2])
    marks.append(("pca", "end", time.perf_counter()))
    res_knn = fleet.rollout("knn", "knn", {"database": rows2}, params=served["knn_params"])
    marks.append(("knn", "end", time.perf_counter()))
    t1 = time.perf_counter()
    time.sleep(0.5)
    traffic_a.stop()
    n_a, lat_a = traffic_a.window(t0, t1)
    for model in ("pca", "knn"):
        steps = [(ph, t) for m, ph, t in marks if m == model]
        print(f"phase 32a: {model} rollout "
              + ", ".join(f"{a} {t2 - t1_:.3f} s" for (a, t1_), (_, t2) in zip(steps, steps[1:]))
              + f"; {(res_pca if model == 'pca' else res_knn)}", flush=True)
    print(f"phase 32a: {n_a} routed requests during the rollouts ({t1 - t0:.3f} s) = "
          f"{n_a / (t1 - t0):.1f} requests/s, p50 {lat_a[len(lat_a) // 2] * 1e3:.3f} ms, p99 "
          f"{lat_a[min(len(lat_a) - 1, int(0.99 * len(lat_a)))] * 1e3:.3f} ms (host clock)",
          flush=True)
    check(res_pca["drained"] and res_knn["drained"] and not res_pca["failed"]
          and not res_knn["failed"] and (res_pca["version"], res_knn["version"]) == (3, 2),
          "phase 32a: PCA v2 -> v3 and the index v1 -> v2 rolled out on every replica, drained")
    gens_t = [served["want_t"], p32_solo(reps[1].address, "pca@v3", xs=xs)]
    gens_k = [served["want_k"], p32_solo(reps[2].address, "knn@v2", qs=qs)]
    check(not any(np.array_equal(a[0], b[0]) for a, b in zip(gens_k[0], gens_k[1])),
          "phase 32a: the index versions answer differently")
    held = {k: p32_exists(r.address, ("pca@v2", "knn@v1", "pca@v3", "knn@v2"))
            for k, r in procs.items() if r is not spare}
    check(all(h == {"pca@v2": False, "knn@v1": False, "pca@v3": True, "knn@v2": True}
              for h in held.values()),
          f"phase 32a: after the drain every replica holds only the new versions ({held})")

    # -- c. the autoscaler: a load spike scales out onto the spare, then back in ----------
    admitted, drained, victim_counts = {}, [], {}
    add_replica = fleet.table.add_replica

    def admit(endpoint):
        key = "%s:%d" % tuple(endpoint)
        snap = p31_metrics(procs[key].address)
        admitted.update(key=key, warmups=p29_metric(snap, "srml_daemon_requests_total",
                                                    op="warmup"),
                        routed=sum(p29_metric(snap, "srml_daemon_requests_total", op=op)
                                   for op in ("transform", "kneighbors")),
                        at=time.perf_counter())
        return add_replica(endpoint)

    fleet.table.add_replica = admit

    def spawn():
        admitted["asked"] = time.perf_counter()
        return spare.address

    def drain(key):
        victim = procs.pop(key)
        victim_counts[key] = (victim.launches()[0].get("dist_topk", 0),
                              p29_metric(p31_metrics(victim.address),
                                         "srml_daemon_requests_total", op="transform"))
        victim.stop()
        drained.append((key, time.perf_counter()))

    # The controller starts from an empty registry, as in a process of its
    # own: the autoscaler reads every objective breaching in its process, and
    # phase 30's unreachable p99 objective left srml_slo_breach at 1 here.
    metrics_mod.reset()
    before = metrics_mod.snapshot()
    jdir = tempfile.mkdtemp(prefix="srml-phase32-")
    jpath = os.path.join(jdir, "journal.jsonl")
    scaler = AutoScaler(fleet, spawn, drain, high_watermark=P32_HIGH, low_watermark=P32_LOW,
                        cooldown_s=P32_COOLDOWN_S, tick_s=P32_TICK_S, min_replicas=3,
                        max_replicas=4)

    def live():
        return len([r for r in fleet.table.replicas() if r.alive])

    def wait_for(what, cond):
        t_end = time.perf_counter() + P32_WAIT_S
        while not cond():
            if time.perf_counter() > t_end:
                fail(f"phase 32c: no {what} within {P32_WAIT_S} s: {scaler.status()}")
            time.sleep(0.02)

    with config.option("run_journal", jpath), journal.run("phase32c"):
        traffic_c = _P32Traffic(np, lambda: fleet.client(client_kwargs=P32_CLIENT), xs, qs,
                                P32_SPIKE)
        t_spike = time.perf_counter()
        try:
            scaler.start()
            traffic_c.start()
            wait_for("scale_up", lambda: live() == 4 and scaler.status()["last_action"]
                     .get("action") == "scale_up")
            t_up = time.perf_counter()
            time.sleep(1.0)  # the spike on four replicas
            traffic_c.level = 1  # the spike passes; one thread keeps requests in flight
            t_calm = time.perf_counter()
            wait_for("scale_down", lambda: bool(drained))
            t_down = time.perf_counter()
            time.sleep(0.5)
        finally:
            traffic_c.stop()
            scaler.stop()
    journal.close()
    after = metrics_mod.snapshot()
    acts = {a: p29_delta(before, after, "srml_autoscale_actions_total", action=a, outcome="ok")
            for a in ("scale_up", "scale_down")}
    status = scaler.status()
    print(f"phase 32c: load spike of {P32_SPIKE} threads to the scale-up's admission "
          f"{admitted.get('at', t_up) - t_spike:.3f} s (spawn to admission "
          f"{admitted.get('at', t_up) - admitted.get('asked', t_up):.3f} s); calm to the "
          f"drained victim {t_down - t_calm:.3f} s; actions {acts}; last decision "
          f"{status['last_decision']}", flush=True)
    check(acts == {"scale_up": 1.0, "scale_down": 1.0},
          f"phase 32c: one scale_up and one scale_down ({acts})")
    check(admitted.get("key") == "%s:%d" % spare.address and admitted["warmups"] == 2
          and admitted["routed"] == 0,
          f"phase 32c: the newcomer warmed both models before its admission, with no routed "
          f"request ({admitted})")
    victim = drained[0][0]
    newcomer_routed = (victim_counts[victim][1] if victim == admitted["key"] else
                       p29_metric(p31_metrics(spare.address), "srml_daemon_requests_total",
                                  op="transform"))
    check(newcomer_routed > 0, f"phase 32c: the newcomer served routed requests after its "
                               f"admission ({newcomer_routed})")
    events = trace_tool.load([jpath])
    spans = {e["name"]: e["duration_s"] for e in events
             if e.get("event") == "phase" and str(e.get("name")).startswith("autoscale.")}
    print(f"phase 32c: the journal's action spans {spans}; victim {victim}", flush=True)
    check(set(spans) == {"autoscale.scale_up", "autoscale.scale_down"},
          f"phase 32c: tools.trace read both action spans back from the journal ({spans})")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        top_tool.main([seed if seed in procs else next(iter(procs)), "--once", "--fleet"])
    panel = buf.getvalue()
    print(panel, flush=True)
    rows_ = [ln.split() for ln in panel.splitlines()]
    up_rows = [r for r in rows_ if len(r) == 6 and r[1] in procs and r[3] == "up" and r[5] == "ok"]
    models = {r[0]: r[1] for r in rows_ if r[:1] in (["pca"], ["knn"])}
    check(len(up_rows) == len(procs) == 3 and models == {"pca": "v4", "knn": "v3"},
          f"phase 32c: tools.top --once --fleet shows the three replicas up and pca v4, knn "
          f"v3 active ({len(up_rows)} up rows, {models})")

    # -- b. a controller process dying mid-rollout, twice ------------------------------------
    seeds = sorted(procs)
    traffic_b = _P32Traffic(np, lambda: FleetClient.from_seeds(seeds[0], client_kwargs=P32_CLIENT),
                            xs, qs, P32_THREADS).start()
    deaths = []
    try:
        for (proc, cq, oq), (arrays, version, phase, action) in zip(
                controllers, ((pcas[0], 5, "flipped", "completed"),
                              (pcas[1], 6, "registering", "aborted"))):
            msg = oq.get(timeout=P31_DAEMON_TIMEOUT_S)
            if msg[0] != "ready":
                fail(f"phase 32b: a controller process failed to start: {msg}")
            cq.put(("go", seeds[version % 3], arrays, version))
            proc.join(timeout=120)
            t_dead = time.perf_counter()
            with ModelFleet.from_seeds([seeds[(version + 1) % 3]],
                                       client_kwargs=P32_CLIENT) as successor:
                intent = successor.table.intent("pca") or {}
                res = successor.resume_rollout("pca")
            t_done = time.perf_counter()
            deaths.append((version, proc.exitcode, intent.get("phase"), res, t_done - t_dead))
            print(f"phase 32b: the controller rolling PCA to v{version} died (exit "
                  f"{proc.exitcode}) in phase {intent.get('phase')}; its successor "
                  f"{res['action']} the rollout {t_done - t_dead:.3f} s after the death",
                  flush=True)
            check(proc.exitcode == 17 and intent.get("phase") == phase
                  and intent.get("to_version") == version and res["action"] == action,
                  f"phase 32b: the death at {phase} left its intent on the fleet and the "
                  f"successor {action} the rollout ({res})")
            if version == 5:
                gens_t.append(p32_solo(procs[seeds[0]].address, "pca@v5", xs=xs))
        time.sleep(0.5)
    finally:
        traffic_b.stop()
        for proc, _, _ in controllers:
            proc.join(timeout=30)
            if proc.is_alive():
                proc.terminate()
    held = {k: p32_exists(r.address, ("pca@v4", "pca@v5", "pca@v6", "knn@v3"))
            for k, r in procs.items()}
    check(all(h == {"pca@v4": False, "pca@v5": True, "pca@v6": False, "knn@v3": True}
              for h in held.values()),
          f"phase 32b: PCA v5 completed and v6 aborted on every replica ({held})")

    # -- every answer of the phase, and the launches ------------------------------------------
    bad, n = p32_check_answers(np, (("a", traffic_a), ("c", traffic_c), ("b", traffic_b)),
                               gens_t, gens_k)
    check(not bad and n > 0, f"phase 32: every one of {n} routed requests answered, bitwise the "
                             f"solo answer of a version, no thread going back a version "
                             f"({len(bad)} not: {bad[:3]})")
    fleet.close()
    launches = sum(c for c, _ in victim_counts.values())
    launches += sum(r.launches()[0].get("dist_topk", 0) for r in procs.values())
    print(f"phase 32: dist_topk launches over the replicas {launches}; "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    check(launches >= 1, f"phase 32: the routed exact requests ran dist_topk ({launches})")
    return {"dist_topk": launches}


def phase_fleet(torch, kernels, config):
    """Phase 31: durable daemons (a, b) and the routed fleet (c), every
    daemon a spawned process. Returns {(part, kernel): launches}."""
    import multiprocessing as mp
    import shutil
    import tempfile

    import numpy as np

    from spark_rapids_ml_tpu_torch.spark import estimator as est

    print("phase 31 prediction (NVIDIA H100, written before the first timed run): a. a "
          "snapshot 0.1 MB and 1-5 ms a boundary; death to the replay's scan 9-15 s (a "
          "process start and the card's context dominate); b. snapshots ivf about 6.4 GB in "
          "3-8 s, exact 3.2 GB in 1.5-4 s; the first kneighbors after the restart 3-7 s (ivf) "
          "and 1.5-3 s (exact); c. 150-400 requests/s, p50 3-10 ms, p99 50-500 ms, 5-40 dead "
          "failovers, the views converged in 0.2-1.0 s; phase 31 110-160 s", flush=True)
    t_phase = time.perf_counter()
    sd = tempfile.mkdtemp(prefix="srml-phase31-")
    print(f"phase 31: state directories under {sd}; disk: "
          f"{shutil.disk_usage(sd).free / 2**30:.1f} GiB free", flush=True)
    ctx = mp.get_context("spawn")
    out = {}
    # The daemons of a and b and the task pool start together (their imports
    # and CUDA contexts overlap); c's replicas start as b begins, so they
    # come up behind b's work.
    state = {name: os.path.join(sd, name)
             for name in ("a-clean", "a-fault", "b", "c0", "c1", "c2", "c3")}
    clean = _P31Daemon(ctx, DEV, state_dir=state["a-clean"], port=0)
    doomed = _P31Daemon(ctx, DEV, plan=P31_CRASH, state_dir=state["a-fault"], port=0)
    index = _P31Daemon(ctx, DEV, state_dir=state["b"], port=0)
    reps = []
    pool = _P21Pool(("127.0.0.1", 1), {**P31_RUNS, **P31_KNN_RUNS}, wait=False)
    try:
        pool.ready()
        t0 = time.perf_counter()
        p31_durable_fit(np, est, pool, clean, doomed)
        print(f"phase 31a passed ({time.perf_counter() - t0:.1f} s)", flush=True)
        reps += [_P31Daemon(ctx, DEV, state_dir=state[f"c{r}"], port=0,
                            gossip_interval_s=P31_GOSSIP_S, serve_batching=False)
                 for r in range(3)]
        t0 = time.perf_counter()
        for k, v in p31_durable_index(np, est, pool, index).items():
            out[("durable", k)] = v
        print(f"phase 31b passed ({time.perf_counter() - t0:.1f} s)", flush=True)
    finally:
        pool.close()
        for d in (clean, doomed, index):
            d.stop()
    t0 = time.perf_counter()
    # Phase 32's spare replica, the autoscaler's new host, comes up while 31c runs.
    spare = _P31Daemon(ctx, DEV, state_dir=state["c3"], port=0,
                       gossip_interval_s=P31_GOSSIP_S, serve_batching=False)
    try:
        launches, served = p31_fleet(torch, np, reps)
        for k, v in launches.items():
            out[("fleet", k)] = v
        print(f"phase 31c passed ({time.perf_counter() - t0:.1f} s)", flush=True)
        print(f"phase 31: {time.perf_counter() - t_phase:.1f} s", flush=True)
        t0 = time.perf_counter()
        for k, v in phase_control(torch, np, reps, spare, served).items():
            out[("control", k)] = v
        print(f"phase 32 passed ({time.perf_counter() - t0:.1f} s)", flush=True)
    finally:
        for r in reps + [spare]:
            r.stop()
    shutil.rmtree(sd, ignore_errors=True)
    return out


# -- 33. the model axis: a (data, model) mesh of ranks on the card ----------------

P33_SEED = 33
P33_D = 10240  # a width whose f32 (d, d) Gram (400 MiB) is over the 256 MiB budget
P33_ROWS = 1 << 17  # a data row's rows: 262,144 over the 2 x 2 mesh's two data rows
P33_CHUNK = 1 << 14  # rows generated a call (the generator's draws, chunked alike everywhere)
P33_RANKS = 4
P33_RANK_TIMEOUT_S = 420
#: The kernels of the phase's path (33b), as the kernels JSON names them.
P33_KERNELS = ("probe_select", "ivf_scan_select")
P33_SPANS = ("compute cov", "eig finalize", "collective gather", "collective reduce",
             "collective shift")


def p33_rows(torch, data_index, kind):
    """One data row's (P33_ROWS, P33_D) bf16 rows on the card, made in
    P33_CHUNK-row draws from the row's seed: {-1, 0, 1} integers ("int":
    every Gram entry of all 262,144 rows is an integer below 2^24, exact in
    f32 in any order) or phase 3's spectrum at width P33_D ("gauss")."""
    g = torch.Generator(device=DEV).manual_seed(P33_SEED * 100 + 10 * (kind == "gauss")
                                                + data_index)
    out = torch.empty((P33_ROWS, P33_D), dtype=torch.bfloat16, device=DEV)
    if kind == "gauss":
        j = torch.arange(P33_D, device=DEV, dtype=torch.float32)
        scales = torch.where(j < K, torch.sqrt(2.0 - j / (K - 1)), 0.1 * 0.999 ** j)
        mu = 0.05 * torch.randn((P33_D,), generator=g, device=DEV)
    for r0 in range(0, P33_ROWS, P33_CHUNK):
        if kind == "int":
            out[r0:r0 + P33_CHUNK] = torch.randint(-1, 2, (P33_CHUNK, P33_D), generator=g,
                                                   device=DEV, dtype=torch.int8)
        else:
            z = torch.randn((P33_CHUNK, P33_D), generator=g, device=DEV)
            out[r0:r0 + P33_CHUNK] = z * scales + mu
    return out


def p33_all_gather_stats(mesh):
    """fn(block, mask) → (count, colsum, slab): the 2-D stats by an
    all-gather of the full width onto every rank (the JAX package's
    ``sharded_stats_2d``, which the port does not have), the plain version
    phase 33a holds the ring against, bitwise and in peak memory."""
    import torch

    from spark_rapids_ml_tpu_torch.ops import gram as gram_ops
    from spark_rapids_ml_tpu_torch.parallel import mapreduce as mr

    def fn(block, mask):
        xm = block * mask.to(block.dtype)[:, None]
        x_full = mr.all_concat(xm, "model", axis=1, mesh=mesh)
        count = mr.reduce_sum(mask.to(torch.int64).sum().to(torch.float32), "data", mesh=mesh)
        colsum = mr.reduce_sum(x_full.sum(dim=0, dtype=torch.float32), "data", mesh=mesh)
        slab = gram_ops._mm_accum(xm.T, x_full, torch.float32)
        del x_full
        return count, colsum, mr.reduce_sum(slab, "data", mesh=mesh)

    return fn


def _p33_rank(rank, port, tmpdir, q) -> None:
    """Phase 33's rank, in a spawned process: reports its numbers to the
    parent over ``q`` and exits non-zero on a failed check."""
    try:
        q.put(("ok", rank, _p33_body(rank, port, tmpdir)))
    except BaseException as e:  # noqa: BLE001 - a failed check exits; reported to the parent
        q.put(("err", rank, repr(e)))
        raise


def _p33_body(rank, port, tmpdir) -> dict:
    import numpy as np
    import torch

    from spark_rapids_ml_tpu_torch.models import knn
    from spark_rapids_ml_tpu_torch.models.pca import fit_pca
    from spark_rapids_ml_tpu_torch.ops import gram as gram_ops
    from spark_rapids_ml_tpu_torch.ops import kernels
    from spark_rapids_ml_tpu_torch.parallel import distributed
    from spark_rapids_ml_tpu_torch.parallel import mapreduce as mr
    from spark_rapids_ml_tpu_torch.parallel.sharding import shard_rows_2d
    from spark_rapids_ml_tpu_torch.utils import profiling

    torch.set_num_threads(2)
    distributed.initialize_cluster(f"127.0.0.1:{port}", P33_RANKS, rank, backend="gloo")
    # Every rank builds the 2 x 2 mesh's groups, then takes the 4 x 1 mesh.
    m22 = distributed.global_mesh(model=2)
    m41 = distributed.global_mesh()
    check(m22.device.type == torch.device(DEV).type, f"33 rank {rank}: on {m22.device}")
    tag = f"33a rank {rank} {m22.coords}:"
    out = {"coords": m22.coords}

    def barrier():
        mr.reduce_sum(torch.zeros(1, device=DEV), "data", mesh=m41)
        torch.cuda.synchronize()

    def spans():
        tot = profiling.span_totals()
        return {name: tot.get(name, (0.0, 0)) for name in P33_SPANS}

    # -- 33a: the ring's feature-sharded Gram of small-integer rows, and a plain
    # all-gather of the same blocks --
    kernels.reset_launches()
    x = p33_rows(torch, m22.coords[0], "int")
    block, mask, n_true = shard_rows_2d(x, m22)
    del x
    torch.cuda.empty_cache()
    digests = {}
    for algo, fn in (("2d", p33_all_gather_stats), ("ring", gram_ops.sharded_stats_ring)):
        barrier()
        torch.cuda.reset_peak_memory_stats()
        profiling.reset_span_totals()
        staged = dict(mr.STAGED)
        t0 = time.perf_counter()
        count, colsum, slab = fn(m22)(block, mask)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        out[algo] = {"s": s, "peak": torch.cuda.max_memory_allocated(), "spans": spans(),
                     "staged": {k_: mr.STAGED[k_] - staged[k_] for k_ in staged}}
        digests[algo] = _digest(slab.cpu().numpy())
        out[algo]["count"], out[algo]["colsum"] = float(count), _digest(colsum.cpu().numpy())
        del count, colsum, slab
        torch.cuda.empty_cache()
    check(digests["2d"] == digests["ring"]
          and out["2d"]["colsum"] == out["ring"]["colsum"]
          and out["2d"]["count"] == out["ring"]["count"] == n_true == 2 * P33_ROWS,
          f"{tag} the ring's and a plain all-gather's slabs ({P33_D // 2} x {P33_D} f32) "
          "bitwise equal "
          f"({digests['2d']}), count {n_true}")
    out["slab"] = digests["2d"]
    del block, mask
    torch.cuda.empty_cache()

    # -- 33a: PCA at a width one device refuses: the randomized fit, model-sharded --
    x = p33_rows(torch, m22.coords[0], "gauss")
    barrier()
    torch.cuda.reset_peak_memory_stats()
    profiling.reset_span_totals()
    t0 = time.perf_counter()
    sol = fit_pca(x, k=K, solver="randomized", mesh=m22)
    out["fit"] = {"s": time.perf_counter() - t0, "spans": spans(),
                  "peak": torch.cuda.max_memory_allocated(), "pc": sol.pc,
                  "n_rows": sol.n_rows}
    check(sol.pc.shape == (P33_D, K) and bool(np.isfinite(sol.pc).all())
          and sol.n_rows == 2 * P33_ROWS,
          f"{tag} randomized fit_pca at d={P33_D}: pc {sol.pc.shape} finite, n_rows {sol.n_rows}")
    out["a_launches"] = sum(kernels.LAUNCHES.values())  # the 2-D route's products are cuBLAS
    del x, sol
    torch.cuda.empty_cache()

    # -- 33b: the sharded IVF index, 4 x 1 ----------------------------------------
    tag = f"33b rank {rank}:"
    arrays = {name: np.load(os.path.join(tmpdir, f"{name}.npy"), mmap_mode="r")
              for name in ("centroids", "lists", "list_ids", "list_mask")}
    qs = np.load(os.path.join(tmpdir, "queries.npy"))
    model = knn.ApproximateNearestNeighborsModel(index=knn.IVFFlatIndex(**arrays))
    model._set(k=KNN_K, nprobe=KNN_NPROBE)
    barrier()
    t0 = time.perf_counter()
    model.shard_index(m41)
    shard_s = time.perf_counter() - t0
    model.kneighbors(qs)  # warm-up: the residual copy of this rank's lists
    barrier()
    kernels.reset_launches()
    t0 = time.perf_counter()
    d_s, i_s = model.kneighbors(qs)
    query_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    routes = {k_: v for k_, v in kernels.ROUTES.items() if k_.split("/")[0] in P33_KERNELS and v}
    check({name: n for name, n in launches.items() if n} == {"probe_select": 1,
                                                                "ivf_scan_select": 1}
          and routes == {"probe_select/fused": 1, "ivf_scan_select/wgmma": 1},
          f"{tag} kneighbors: one probe_select launch on the fused route and one "
          f"ivf_scan_select on the tensor-core route ({routes}); "
          f"{model._shard[1][2].shape[0]} lists here")
    out["ivf"] = {"d": d_s, "i": i_s, "s": query_s, "shard_s": shard_s, "launches": launches,
                  "lists": int(model._shard[1][2].shape[0]), "staged": dict(mr.STAGED)}
    barrier()
    distributed.shutdown_cluster()
    return out


def p33_build_index(torch) -> dict:
    """Phase 17's index, queries, ground truth and unsharded answer, built
    here when phase 17 did not run in this call (``--model-axis``)."""
    from spark_rapids_ml_tpu_torch import ApproximateNearestNeighbors

    gen = torch.Generator(device=DEV).manual_seed(9)  # phase 17's data
    centers = torch.randn((KNN_CLUSTERS, KNN_D), generator=gen, device=DEV)
    x = knn_data(torch, gen, KNN_ROWS, centers)
    qs = knn_data(torch, gen, KNN_QUERIES, centers)
    del centers
    t0 = time.perf_counter()
    ann = (ApproximateNearestNeighbors().setK(KNN_K).setNlist(KNN_NLIST)
           .setNprobe(KNN_NPROBE).fit({"features": x}))
    build_s = time.perf_counter() - t0
    _, gt_i = brute_force64(torch, x, qs, KNN_K)
    del x
    ann.kneighbors(qs)  # warm-up: the upload and the residual copy
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d_u, i_u = ann.kneighbors(qs)
    query_s = time.perf_counter() - t0
    out = p17_save(torch, ann, qs, gt_i, d_u, i_u, query_s, build_s)
    del ann, qs
    torch.cuda.empty_cache()
    return out


def phase_model_axis(torch, kernels, config) -> dict:
    """Phase 33: the model axis on the card. Returns the path kernels'
    launches summed over 33b's four ranks."""
    import multiprocessing as mp
    import shutil

    import numpy as np

    from spark_rapids_ml_tpu_torch.models.pca import fit_pca
    from spark_rapids_ml_tpu_torch.ops.gram import GramCapacityError

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    # -- 33b's index and its unsharded answer: phase 17's, else built here -------
    ivf = P17_INDEX if P17_INDEX else p33_build_index(torch)
    tmpdir, gt_i, d_u, i_u, plain_s = (ivf[k_] for k_ in ("dir", "gt_i", "d", "i", "s"))
    print(f"33b: phase 17's index ({'from phase 17' if ivf is P17_INDEX else 'built here'}, "
          f"built in {ivf['build_s']:.3f} s) on disk at {tmpdir}", flush=True)
    try:
        # -- 33a: one device refuses the width -------------------------------------
        try:
            fit_pca(torch.zeros((16, P33_D), device=DEV), k=K, solver="randomized")
            refusal = None
        except GramCapacityError as e:
            refusal = str(e)
        check(refusal is not None and "mesh_model_axis >= 2" in refusal,
              f"33a: a world-of-one fit_pca at d={P33_D} raises GramCapacityError naming "
              f"mesh_model_axis: {refusal}")

        ctx = mp.get_context("spawn")  # never fork a process that holds a CUDA context
        q = ctx.Queue()
        port = _free_port()
        t0 = time.perf_counter()
        procs = [ctx.Process(target=_p33_rank, args=(r, port, tmpdir, q))
                 for r in range(P33_RANKS)]
        for p in procs:
            p.start()
        res = _await(procs, q, P33_RANKS, P33_RANK_TIMEOUT_S, "33")
        ranks_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
        P17_INDEX.clear()

    # -- 33a against one process: the gram kernel of all the rows, float64 eigh --
    x = torch.cat([p33_rows(torch, d, "int") for d in range(2)])
    g = kernels.gram(x)  # a comparison launch, not the path's
    del x
    half = P33_D // 2
    blocks = [_digest(g[m * half:(m + 1) * half].cpu().numpy()) for m in range(2)]
    del g
    torch.cuda.empty_cache()
    for r in range(P33_RANKS):
        m = res[r]["coords"][1]
        check(res[r]["slab"] == blocks[m],
              f"33a rank {r}: its slab bitwise equal to rows {m * half}..{(m + 1) * half} of "
              f"the one-process gram kernel of all {2 * P33_ROWS} rows ({blocks[m]})")
    count = torch.zeros((), dtype=torch.float64, device=DEV)
    colsum = torch.zeros(P33_D, dtype=torch.float64, device=DEV)
    gram = torch.zeros((P33_D, P33_D), dtype=torch.float64, device=DEV)
    for d in range(2):
        xb = p33_rows(torch, d, "gauss")
        for r0 in range(0, P33_ROWS, P33_CHUNK):
            xd = xb[r0:r0 + P33_CHUNK].double()
            gram.addmm_(xd.T, xd)
            colsum += xd.sum(0)
            count += xd.shape[0]
        del xb, xd
    t0 = time.perf_counter()
    pc_ref, _, gap = reference_pca(count, colsum, gram, K)
    eigh_s = time.perf_counter() - t0
    del gram
    for r in range(P33_RANKS):
        err = sign_aligned_err(res[r]["fit"]["pc"], pc_ref)
        # Tolerance: phase 3's; the reference eigh reads the same bf16 rows.
        check(err <= 1e-3, f"33a rank {r}: randomized model-sharded pc (k={K}) vs float64 eigh "
                           f"of the same bf16 rows on the card: max sign-aligned err {err:.3e} "
                           f"(tol 1e-3; smallest top-{K} eigengap {gap:.3e}; reference eigh "
                           f"{eigh_s:.2f} s)")
        for algo, label in (("2d", "plain all-gather"), ("ring", "ring")):
            a = res[r][algo]
            print(f"33a rank {r} {label}: sharded stats of {P33_ROWS} x {P33_D} bf16 rows a data "
                  f"row {a['s']:.3f} s, peak {a['peak'] / 2**30:.3f} GiB "
                  f"(torch.cuda.max_memory_allocated), collectives "
                  + ", ".join(f"{n} {v[0]:.3f} s/{v[1]}" for n, v in a["spans"].items()
                              if n.startswith("collective") and v[1])
                  + f", staged {a['staged']}", flush=True)
        check(res[r]["ring"]["peak"] < res[r]["2d"]["peak"],
              f"33a rank {r}: the ring's peak {res[r]['ring']['peak'] / 2**30:.3f} GiB below the "
              f"all-gather's {res[r]['2d']['peak'] / 2**30:.3f} GiB")
        f = res[r]["fit"]
        print(f"33a rank {r}: fit_pca(solver='randomized', d={P33_D}, k={K}; the ring) "
              f"{f['s']:.3f} s, "
              f"peak {f['peak'] / 2**30:.3f} GiB; stats ('compute cov') "
              f"{f['spans']['compute cov'][0]:.3f} s, eigensolve ('eig finalize') "
              f"{f['spans']['eig finalize'][0]:.3f} s; collectives "
              + ", ".join(f"{n} {v[0]:.3f} s/{v[1]}" for n, v in f["spans"].items()
                          if n.startswith("collective") and v[1]), flush=True)

    # -- 33b against the unsharded query --------------------------------------------
    d_s, i_s = res[0]["ivf"]["d"], res[0]["ivf"]["i"]
    for r in range(1, P33_RANKS):
        check(_digest(res[r]["ivf"]["d"], res[r]["ivf"]["i"]) == _digest(d_s, i_s),
              f"33b rank {r}: the same answer as rank 0")
    same = (np.sort(i_s, 1) == np.sort(i_u, 1)).all(1)
    rows_ok = np.allclose(np.sort(d_s[same], 1), np.sort(d_u[same], 1), rtol=1e-5, atol=0)
    rec_s, rec_u = recall_at(i_s, gt_i), recall_at(i_u, gt_i)
    check(rows_ok and (same.all() or rec_s >= rec_u),
          f"33b: the sharded answer (4 x 1, {res[0]['ivf']['lists']} lists a rank) vs the "
          f"unsharded query: {int(same.sum())} of {same.size} rows with equal ids (sorted), their "
          f"distances within rtol 1e-5; {int((~same).sum())} rows differ; recall@{KNN_K} sharded "
          f"{rec_s:.5f}, unsharded {rec_u:.5f} (float64 ground truth)")
    launches = {name: sum(res[r]["ivf"]["launches"][name] for r in range(P33_RANKS))
                for name in res[0]["ivf"]["launches"]}
    q_s = max(res[r]["ivf"]["s"] for r in range(P33_RANKS))
    print(f"33b: IVF kneighbors of {KNN_QUERIES} queries (nlist {KNN_NLIST}, nprobe {KNN_NPROBE}, "
          f"k={KNN_K}): unsharded {KNN_QUERIES / plain_s:.1f} q/s ({plain_s:.3f} s); sharded over "
          f"4 gloo ranks on one card {KNN_QUERIES / q_s:.1f} q/s ({q_s:.3f} s, the slowest "
          f"rank); shard_index {max(res[r]['ivf']['shard_s'] for r in range(P33_RANKS)):.3f} s; "
          f"staged {res[0]['ivf']['staged']}", flush=True)
    print(f"33: phase seconds {time.perf_counter() - t_phase:.1f} (ranks {ranks_s:.1f}); "
          f"kernel launches summed over the ranks: 33a "
          f"{sum(res[r]['a_launches'] for r in range(P33_RANKS))} (its products are cuBLAS), "
          f"33b {launches}", flush=True)
    return {name: launches[name] for name in P33_KERNELS}


P34_ROWS = 4096  # one small fold: the phase checks where the libraries load


def phase_analyze(torch, kernels, config) -> None:
    """Phase 34 (see the module docstring): the analyzer on this host, the
    daemon's start-up load and a fold that builds nothing under the lock."""
    import numpy as np

    from spark_rapids_ml_tpu_torch.ops import _build
    from spark_rapids_ml_tpu_torch.serve import DataPlaneClient, DataPlaneDaemon
    from spark_rapids_ml_tpu_torch.serve import daemon as daemon_mod
    from spark_rapids_ml_tpu_torch.utils.profiling import reset_span_totals, span_totals

    t_phase = time.perf_counter()
    # a. srml-check on the tree, with this host's Python.
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "spark_rapids_ml_tpu_torch.tools.analyze", "--json"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
        timeout=120)
    analyze_s = time.perf_counter() - t0
    try:
        payload = json.loads(proc.stdout)
    except ValueError:
        fail(f"phase 34a: srml-check printed no JSON (exit {proc.returncode}): "
             f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    for f in payload["findings"]:
        print(f"  {f['file']}:{f['line']}: [{f['rule']}] {f['message']}")
    check(proc.returncode == 0 and payload["ok"] and payload["findings"] == [],
          f"phase 34a: srml-check on Python {sys.version.split()[0]}: "
          f"{len(payload['rules'])} rules, {len(payload['findings'])} unsuppressed findings, "
          f"exit {proc.returncode}, {analyze_s:.2f} s")

    # b. The start-up load, counted by whether _DEVICE_LOCK was held.
    loaders = (kernels._lib, kernels._kmeans_lib, kernels._knn_lib)
    calls = {"build": [0, 0], "load": [0, 0]}  # [outside, under] _DEVICE_LOCK
    orig = {"build": _build.build, "load": _build.load}

    def counted(name):
        def wrapper(*args, **kwargs):
            calls[name][int(daemon_mod._DEVICE_LOCK.locked())] += 1
            return orig[name](*args, **kwargs)
        return wrapper

    for loader in loaders:
        loader.cache_clear()
    _build.load.cache_clear()
    check(all(f.cache_info().currsize == 0 for f in loaders),
          "phase 34b: the three loaders' caches are empty before the daemon starts")
    _build.build, _build.load = counted("build"), counted("load")
    d = None
    try:
        reset_span_totals()
        d = DataPlaneDaemon()
        t0 = time.perf_counter()
        d.start()
        start_s = time.perf_counter() - t0
        load_s = span_totals().get("daemon kernel load", (float("nan"), 0))[0]
        filled = [f.cache_info().currsize for f in loaders]
        check(filled == [1, 1, 1] and calls["load"] == [3, 0] and calls["build"][1] == 0,
              f"phase 34b: start() filled the loaders {filled} before the first connection: "
              f"_build.load {calls['load'][0]} calls outside _DEVICE_LOCK, "
              f"{calls['load'][1]} under it; the kernel load {load_s:.3f} s of a "
              f"{start_s:.3f} s start (warm: phase 1 built the libraries)")
        # c. One fold through a client: nothing builds under the lock.
        rng = np.random.default_rng(34)
        x = rng.integers(-3, 4, size=(P34_ROWS, D)).astype(np.float32)
        before = kernels.LAUNCHES["gram_colsum"]
        with DataPlaneClient(*d.address) as c:
            rows = c.feed_raw("phase34", x, n_cols=D)
            out = c.finalize_pca("phase34", K)
        launches = kernels.LAUNCHES["gram_colsum"] - before
        err = float(np.abs(out["mean"].astype(np.float64) - x.astype(np.float64).mean(0)).max())
        check(rows == P34_ROWS and launches == 1 and err <= 1e-6
              and out["pc"].shape == (D, K) and bool(np.isfinite(out["pc"]).all()),
              f"phase 34c: one feed_raw of {P34_ROWS} x {D} small-integer rows: {launches} "
              f"gram_colsum launch, mean max err {err:.2e} (tol 1e-6), pc {out['pc'].shape}")
        check(calls["build"][1] == 0 and calls["load"][1] == 0,
              f"phase 34c: _build.build {calls['build'][1]} and _build.load "
              f"{calls['load'][1]} calls while _DEVICE_LOCK was held (want 0 and 0)")
    finally:
        _build.build, _build.load = orig["build"], orig["load"]
        if d is not None:
            d.stop()
    print(f"phase 34: {time.perf_counter() - t_phase:.1f} s (budget 30 s)", flush=True)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from spark_rapids_ml_tpu_torch import (
        PCA,
        LinearRegression,
        LogisticRegression,
        PCAModel,
        config,
    )
    from spark_rapids_ml_tpu_torch.models import kmeans as km
    from spark_rapids_ml_tpu_torch.models import linear_regression as lr
    from spark_rapids_ml_tpu_torch.models import logistic_regression as lg
    from spark_rapids_ml_tpu_torch.ops.linalg import solve_newton_system
    from spark_rapids_ml_tpu_torch.models.pca import fit_pca_stream
    from spark_rapids_ml_tpu_torch.ops import _build, kernels

    t_start = time.perf_counter()

    def stamp(label: str) -> None:
        """The seconds since the start, where each phase of the whole run begins."""
        print(f"[{time.perf_counter() - t_start:.1f} s] {label}", flush=True)

    # -- 1. card, toolchain, build ---------------------------------------
    stamp("phase 1")
    card = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    card = card.splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    print("nvcc:", run([_build.nvcc(), "--version"]).splitlines()[-1])
    t0 = time.perf_counter()
    built = _build.build_all()
    kernels._lib()
    kernels._kmeans_lib()
    kernels._knn_lib()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s -> "
          + ", ".join(p.name for p in built))
    # The Spark tasks' fork server imports the port while the card works.
    import multiprocessing.forkserver

    task_context()
    multiprocessing.forkserver.ensure_running()
    for name, log in _build.BUILD_LOGS.items():
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry", "warning",
                                       "wgmma", "setmaxnreg")):
                print(f"  ptxas {name}: {line.strip()}")

    if "--analyze" in sys.argv[1:]:
        # Phase 34 alone.
        phase_analyze(torch, kernels, config)
        print(card)
        print(f"phase 34 passed ({time.perf_counter() - t_start:.1f} s); --analyze: stopping "
              "here", flush=True)
        return

    if "--model-axis" in sys.argv[1:]:
        # Phase 33 alone.
        phase_model_axis(torch, kernels, config)
        print(card)
        print(f"phase 33 passed ({time.perf_counter() - t_start:.1f} s); --model-axis: stopping "
              "here", flush=True)
        return

    if "--fleet" in sys.argv[1:]:
        # Phases 31 and 32 alone.
        phase_fleet(torch, kernels, config)
        print(card)
        print(f"phases 31-32 passed ({time.perf_counter() - t_start:.1f} s); --fleet: stopping "
              "here", flush=True)
        return

    if "--telemetry" in sys.argv[1:]:
        # Phase 30 alone.
        phase_telemetry(torch, kernels, config)
        print(card)
        print(f"phase 30 passed ({time.perf_counter() - t_start:.1f} s); --telemetry: stopping "
              "here", flush=True)
        return

    if "--serving" in sys.argv[1:]:
        # Phase 29 alone.
        phase_serving(torch, kernels, config)
        print(card)
        print(f"phase 29 passed ({time.perf_counter() - t_start:.1f} s); --serving: stopping "
              "here", flush=True)
        return

    if "--elastic" in sys.argv[1:]:
        # Phase 28 alone.
        phase_elastic(torch, kernels, config)
        print(card)
        print(f"phase 28 passed ({time.perf_counter() - t_start:.1f} s); --elastic: stopping "
              "here", flush=True)
        return

    if "--multi-daemon" in sys.argv[1:]:
        # Phase 27 alone.
        phase_multidaemon(torch, kernels, config)
        print(card)
        print(f"phase 27 passed ({time.perf_counter() - t_start:.1f} s); --multi-daemon: "
              "stopping here", flush=True)
        return

    if "--multi-process" in sys.argv[1:]:
        # Phase 26 alone.
        phase_multiprocess(torch, card, None)
        print(card)
        print(f"phase 26 passed ({time.perf_counter() - t_start:.1f} s); --multi-process: "
              "stopping here", flush=True)
        return

    if "--data-plane" in sys.argv[1:]:
        # Phases 19 to 22, phase 23's Spark part and phase 25 alone, on phase
        # 3's spectrum.
        j = torch.arange(D, device=DEV, dtype=torch.float32)
        scales = torch.where(j < K, torch.sqrt(2.0 - j / (K - 1)), 0.1 * 0.999 ** j)
        mu = 0.05 * torch.randn((D,), generator=torch.Generator(device=DEV).manual_seed(0),
                                device=DEV)
        _, dp_rate = phase_data_plane(torch, kernels, config, scales, mu, fit_pca_stream,
                                      PCAModel)
        torch.cuda.empty_cache()
        _, sp_rate = phase_spark_feed(torch, kernels, fit_pca_stream, dp_rate)
        torch.cuda.empty_cache()
        phase_iterative_jobs(torch, kernels, config)
        phase_knn_daemon(torch, kernels, config)
        phase_spark_scaler(torch, kernels, config, sp_rate)
        torch.cuda.empty_cache()
        phase_forest_daemon(torch, kernels, config, sp_rate)
        print(card)
        print(f"phases 19-22, 23's Spark part and 25 passed ({time.perf_counter() - t_start:.1f} "
              "s); --data-plane: stopping here", flush=True)
        return

    if "--estimators" in sys.argv[1:]:
        # Phases 23 and 24 alone.
        phase_estimators(torch, kernels, config)
        phase_spark_scaler(torch, kernels, config, None)
        torch.cuda.empty_cache()
        phase_forests(torch, kernels, config)
        print(card)
        print(f"phases 23-24 passed ({time.perf_counter() - t_start:.1f} s); --estimators: "
              "stopping here", flush=True)
        return

    # -- 2. kernels against their plain versions -----------------------------
    stamp("phase 2")
    phase_topk_tc(torch, kernels)
    phase_probe(torch, kernels)
    phase_scan_tc(torch, kernels)
    phase_gram_syrk(torch, kernels)
    phase_kmeans_tc(torch, kernels)
    phase_gram_tc(torch, kernels)
    phase_weighted_tc(torch, kernels)
    phase_kernels(torch, kernels)
    phase_new_kernels(torch, kernels)
    phase_logreg_kernels(torch, kernels)
    if "--phase2" in sys.argv[1:]:
        print(f"phase 2 passed ({time.perf_counter() - t_start:.1f} s); --phase2: stopping here",
              flush=True)
        return

    # -- 3. streaming fit at full width ---------------------------------------
    stamp("phase 3")
    gen = torch.Generator(device=DEV).manual_seed(0)
    j = torch.arange(D, device=DEV, dtype=torch.float32)
    # Column variances 2 − j/31 for the top 32 (eigengaps 1.6 % of the
    # largest), then a 0.01·0.998^j tail far below them.
    scales = torch.where(j < K, torch.sqrt(2.0 - j / (K - 1)), 0.1 * 0.999 ** j)
    mu = 0.05 * torch.randn((D,), generator=gen, device=DEV)
    batches = [
        make_rows(gen, LAST_BATCH_ROWS if b == N_BATCHES - 1 else BATCH_ROWS,
                  scales, mu, torch.bfloat16)
        for b in range(N_BATCHES)
    ]
    n_rows = sum(b.shape[0] for b in batches)
    print(f"streaming fit: {N_BATCHES} bf16 batches, {n_rows} rows x {D} "
          f"(depth cut from bench.py's 384 batches), k={K}")
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    sol = fit_pca_stream(batches, k=K, n_cols=D)
    fit_s = time.perf_counter() - t0  # the solution is on the host: synced
    launches_gc = kernels.LAUNCHES["gram_colsum"]
    routes_gc = {k: v for k, v in kernels.ROUTES.items() if k.startswith("gram_colsum/")}
    check(launches_gc == N_BATCHES,
          f"gram_colsum launches {launches_gc} == batches {N_BATCHES}")
    check(routes_gc["gram_colsum/wgmma"] == N_BATCHES and routes_gc["gram_colsum/ffma"] == 0,
          f"every gram_colsum launch of the stream took the tensor-core route: {routes_gc}")
    print(f"streaming fit: {fit_s:.3f} s, {n_rows / fit_s:.1f} rows/s (fold + finalize)")
    stream_rate = n_rows / fit_s  # printed beside phase 26's two-rank stream
    device_breakdown(torch, "streaming fit trace (a second fit of the same batches)",
                     lambda: fit_pca_stream(batches, k=K, n_cols=D), top=6)
    count = torch.tensor(float(n_rows), dtype=torch.float64, device=DEV)
    colsum = torch.zeros(D, dtype=torch.float64, device=DEV)
    gram = torch.zeros((D, D), dtype=torch.float64, device=DEV)
    for b in batches:
        xd = b.double()
        gram += xd.T @ xd
        colsum += xd.sum(0)
    pc_ref, ev_ref, gap = reference_pca(count, colsum, gram, K)
    print(f"streaming reference: smallest top-{K} eigengap {gap:.3e} of the largest eigenvalue")
    err = sign_aligned_err(sol.pc, pc_ref)
    ev_err = float((torch.as_tensor(sol.explained_variance, device=DEV) - ev_ref).abs().max())
    check(sol.pc.shape == (D, K) and bool(torch.isfinite(torch.as_tensor(sol.pc)).all()),
          f"streaming pc finite, shape {sol.pc.shape}")
    # Tolerance: f32 accumulation over 2M rows (relative error ~1e-5 of the
    # largest Gram entry at worst) over the smallest top-32 eigengap (1.6 %
    # of the largest eigenvalue) bounds the vector error near 1e-3.
    check(err <= 1e-3, f"streaming pc vs float64 Gram: max sign-aligned err {err:.3e} (tol 1e-3)")
    check(ev_err <= 1e-4, f"streaming explained variance err {ev_err:.3e} (tol 1e-4)")
    del gram, colsum

    # -- 4. in-memory PCA().fit: the default dtype, then float32 ---------------
    stamp("phase 4")
    x32 = make_rows(gen, IN_MEMORY_ROWS, scales, mu, torch.float32)
    # The default compute dtype on the card is bf16: the fit casts the rows
    # and its one gram launch takes the tensor-core SYRK.
    kernels.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model_bf = PCA().setK(K).fit({"features": x32})
    mem_bf_s = time.perf_counter() - t0
    extra_gib = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    launches_g = kernels.LAUNCHES["gram"]
    check(launches_g == 1 and kernels.ROUTES["gram/wgmma"] == 1,
          f"default-dtype in-memory fit: gram launches {launches_g} == 1, on the tensor-core "
          f"route ({kernels.ROUTES['gram/wgmma']} wgmma)")
    xd = x32.to(torch.bfloat16).double()  # the rows the bf16 fit reads
    g64_bf = xd.T @ xd  # kept for phase 6's Gram error
    pc_ref, _, gap = reference_pca(
        torch.tensor(float(IN_MEMORY_ROWS), dtype=torch.float64, device=DEV),
        xd.sum(0), g64_bf, K,
    )
    del xd
    err = sign_aligned_err(model_bf.pc, pc_ref)
    print(f"in-memory fit: {IN_MEMORY_ROWS} x {D} at the default dtype (bf16) in "
          f"{mem_bf_s:.3f} s (wall, host clock, first call of the route); peak memory "
          f"{extra_gib:.3f} GiB above the f32 rows (torch.cuda.max_memory_allocated; the "
          f"rows' one bf16 copy is {IN_MEMORY_ROWS * D * 2 / 2 ** 30:.3f} GiB)")
    check(err <= 1e-3, f"default-dtype in-memory pc vs float64 Gram of the bf16-rounded rows: "
                       f"max sign-aligned err {err:.3e} (tol 1e-3; eigengap {gap:.3e})")
    del model_bf
    kernels.reset_launches()
    t0 = time.perf_counter()
    with config.option("compute_dtype", "float32"):
        model32 = PCA().setK(K).fit({"features": x32})
    mem_s = time.perf_counter() - t0
    launches_g32 = kernels.LAUNCHES["gram"]
    check(launches_g32 == 1 and kernels.ROUTES["gram/ffma"] == 1,
          f"float32 in-memory fit: gram launches {launches_g32} == 1, on the FFMA SYRK route")
    print(f"in-memory fit: {IN_MEMORY_ROWS} x {D} float32 in {mem_s:.3f} s")
    xd = x32.double()
    g64_mem = xd.T @ xd  # kept for phase 6's Gram error
    pc_ref, ev_ref, gap = reference_pca(
        torch.tensor(float(IN_MEMORY_ROWS), dtype=torch.float64, device=DEV),
        xd.sum(0), g64_mem, K,
    )
    del xd
    print(f"in-memory reference: smallest top-{K} eigengap {gap:.3e} of the largest eigenvalue")
    err = sign_aligned_err(model32.pc, pc_ref)
    check(err <= 1e-3, f"in-memory pc vs float64 Gram: max sign-aligned err {err:.3e} (tol 1e-3)")

    # -- 5. transform ----------------------------------------------------------
    stamp("phase 5")
    # The streaming fit's model; transform computes in bf16 (auto on CUDA).
    model = PCAModel(pc=sol.pc, explained_variance=sol.explained_variance, mean=sol.mean)
    xq = batches[0][:TRANSFORM_ROWS]
    y = model.transform_matrix(xq)["output"]
    cd = config.compute_dtype(DEV)  # both operands rounded to it
    pc_c = torch.as_tensor(sol.pc, device=DEV).to(cd).double()
    y_ref = xq.to(cd).double() @ pc_c
    scale = float((xq.double().abs() @ pc_c.abs()).max())
    terr = rel_err(y, y_ref, scale)
    check(tuple(y.shape) == (TRANSFORM_ROWS, K) and y.dtype == torch.float32,
          f"transform output {tuple(y.shape)} {y.dtype}")
    # Tolerance: the same rounded operands summed in f32 over 2048 terms.
    check(terr <= 1e-5, f"transform vs float64 product: rel err {terr:.3e} (tol 1e-5)")
    lat = []
    for _ in range(21):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.transform_matrix(xq)["output"].sum().item()
        lat.append((time.perf_counter() - t0) * 1e3)
    lat.sort()
    print(f"transform {TRANSFORM_ROWS} x {D} bf16 -> k={K}: p50 {lat[len(lat) // 2]:.3f} ms "
          f"(device-resident input, host clock, synced)")

    # -- 6. kernels at the main path's shape ------------------------------------
    stamp("phase 6")
    table = []
    xb = batches[0]
    del batches
    xbd = xb.double()
    g64_batch = xbd.T @ xbd
    del xbd
    n, d = xb.shape
    state = (torch.zeros((d, d), device=DEV), torch.zeros(d, device=DEV),
             torch.zeros((), device=DEV))
    ms = time_ms(lambda: kernels.gram_colsum(xb, n, state), 5)
    plain_ms = time_ms(lambda: kernels.gram_colsum_plain(xb, n, state), 3)
    lib_ms = time_ms(lambda: torch.matmul(xb.T, xb), 5)
    gk = kernels.gram_colsum(xb, n)
    gp = kernels.gram_colsum_plain(xb, n)
    gscale = float(gp[0].diagonal().max())
    cscale = float(xb.float().abs().sum(0).max())
    err_g = rel_err(gk[0], gp[0], gscale)
    err_c = rel_err(gk[1], gp[1], cscale)
    # Tolerance: f32 sums over 262,144 rows in another order, 1e-4 relative.
    check(err_g <= 1e-4 and err_c <= 1e-4 and float(gk[2]) == float(gp[2]),
          f"gram_colsum at {n} x {d} bf16: rel err gram {err_g:.2e}, colsum {err_c:.2e} (tol 1e-4)")
    print(f"gram_colsum at {n} x {d} bf16, Gram vs float64 (over the largest diagonal "
          f"entry): kernel {rel_err(gk[0], g64_batch, gscale):.3e}, "
          f"plain {rel_err(gp[0], g64_batch, gscale):.3e}")
    promote_sweep(torch, kernels, lambda: kernels.gram_colsum(xb, n, state)[0],
                  lambda: kernels.gram_colsum(xb, n)[0], g64_batch, gscale, f"gram_colsum {n} x {d}")
    # Bound: x read once, the state read and written once; G is symmetric,
    # so nd(d+1) operations, plus nd for the column sums.
    b_ms, b_by = bound_ms(n * d * 2 + 2 * (d * d * 4 + d * 4 + 4), n * d * (d + 1) + n * d,
                          "bfloat16")
    table.append({
        "name": "gram_colsum", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES["gram_colsum"], "launches": launches_gc,
        "max_abs_err": float((gk[0] - gp[0]).abs().max()),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms,
    })
    del gk, gp, state, xb

    # The in-memory fit passes no mask (one device pads nothing). Its main
    # path is the default dtype, bf16 (the tensor-core SYRK); the float32
    # fit's FFMA SYRK is timed beside it, each against its own library call.
    n, d = x32.shape
    x16 = x32.to(torch.bfloat16)
    ms = time_ms(lambda: kernels.gram(x16), 5)
    plain_ms = time_ms(lambda: kernels.gram_plain(x16), 3)
    lib_ms = time_ms(lambda: torch.matmul(x16.T, x16), 5)  # bf16 in and out, tensor cores
    gk = routed(torch, kernels, "gram", "wgmma", lambda: kernels.gram(x16))
    gp = kernels.gram_plain(x16)
    gscale = float(gp.diagonal().max())
    err_g = rel_err(gk, gp, gscale)
    err_k64, err_p64 = rel_err(gk, g64_bf, gscale), rel_err(gp, g64_bf, gscale)
    # The plain version's f32 sums run over all 1,048,576 rows, so the
    # difference to it is mostly its own error: hold the kernel to float64
    # of the same bf16 rows, at 1e-5 of the largest diagonal entry and no
    # worse than the plain version.
    check(err_k64 <= 1e-5 and err_k64 <= err_p64,
          f"gram wgmma at {n} x {d} bf16 (R = {kernels.TC_PROMOTE_STAGES}), Gram vs float64 "
          f"(over the largest diagonal entry): kernel {err_k64:.3e} (tol 1e-5), plain "
          f"{err_p64:.3e}; kernel vs plain {err_g:.2e}")
    b_ms, b_by = bound_ms(n * d * 2 + d * d * 4, n * d * (d + 1), "bfloat16")
    row_g = {
        "name": "gram", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES["gram"], "launches": launches_g,
        "max_abs_err": float((gk - gp).abs().max()),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms,
    }
    del x16, gk, gp, g64_bf
    ms32 = time_ms(lambda: kernels.gram(x32), 3)
    plain32 = time_ms(lambda: kernels.gram_plain(x32), 3)
    lib32 = time_ms(lambda: torch.matmul(x32.T, x32), 3)  # TF32 off: the package pins it
    gk = routed(torch, kernels, "gram", "ffma", lambda: kernels.gram(x32))
    gp = kernels.gram_plain(x32)
    gscale = float(gp.diagonal().max())
    err_g = rel_err(gk, gp, gscale)
    err_k64, err_p64 = rel_err(gk, g64_mem, gscale), rel_err(gp, g64_mem, gscale)
    check(err_g <= 1e-4, f"gram ffma at {n} x {d} f32: rel err {err_g:.2e} (tol 1e-4)")
    # The FFMA route sums each register over at most FFMA_SPLIT_ROWS rows:
    # its error against float64 must not exceed the plain version's.
    check(err_k64 <= err_p64, f"gram ffma at {n} x {d} f32, Gram vs float64 (over the largest "
                              f"diagonal entry): kernel {err_k64:.3e} <= plain {err_p64:.3e}")
    # Bound: x read once, G written once; G is symmetric, so nd(d+1).
    b32, by32 = bound_ms(n * d * 4 + d * d * 4, n * d * (d + 1), "float32")
    row_g.update({"f32_route": "ffma syrk", "f32_ms": ms32, "f32_plain_ms": plain32,
                  "f32_library_ms": lib32, "f32_bound_ms": b32, "f32_launches": launches_g32,
                  "f32_max_abs_err": float((gk - gp).abs().max())})
    table.append(row_g)
    print(f"gram at {n} x {d}: bf16 wgmma {ms:.3f} ms (bf16 torch.matmul {lib_ms:.3f}, plain "
          f"{plain_ms:.3f}, bound {b_ms:.3f} by {b_by}); f32 ffma {ms32:.3f} ms = "
          f"{n * d * (d + 1) / ms32 / 1e9:.1f} TFLOP/s of pairs (f32 torch.matmul {lib32:.3f}, "
          f"plain {plain32:.3f}, bound {b32:.3f} by {by32})", flush=True)
    del x32, g64_mem, gk, gp, model32, model
    torch.cuda.empty_cache()

    # -- 7.-8. KMeans at full width, and its stream ---------------------------
    stamp("phases 7-8")
    xk, ck, km_launches = phase_kmeans(torch, kernels, km, config)

    # -- 9. LinearRegression at width 1024 ------------------------------------
    stamp("phase 9")
    xb, yb, x32, y32, lr_launches = phase_linreg(torch, kernels, lr, LinearRegression, config)

    # -- 10. the KMeans and LinearRegression kernels at their paths' shapes ----
    stamp("phase 10")
    n, d = xk.shape
    k = ck.shape[0]
    ms = time_ms(lambda: kernels.lloyd_step(xk, ck, n), 3)
    plain_ms = time_ms(lambda: kernels.lloyd_step_plain(xk, ck, n), 2)
    # Yardstick: no PyTorch call computes a Lloyd step; the distance product
    # alone (bf16 in and out, tensor cores) is timed, and beside it the
    # whole PyTorch route of each kernel (torch_route below).
    lib_ms = time_ms(lambda: torch.matmul(xk, ck.T), 5)
    route_l = time_ms(lambda: torch_route(torch, kernels, xk, ck, lloyd=True), 2)
    route_a = time_ms(lambda: torch_route(torch, kernels, xk, ck, lloyd=False), 2)
    sk, nk = kernels.lloyd_step(xk, ck, n)
    sp, np_ = kernels.lloyd_step_plain(xk, ck, n)
    means64, counts64, _ = lloyd_reference(torch, xk, ck.float().cpu().numpy(), ck.dtype)
    sums64 = means64 * counts64[:, None]
    scale = float(center_abs_sums(torch, kernels, xk, ck).max())
    err_k, err_p = rel_err(sk, sums64, scale), rel_err(sp, sums64, scale)
    # Tolerance: the kernel sums a centre's 1.7e5 rows per column in f32,
    # about 1.3e3 per block in shared memory and then one atomic add per
    # block; 1e-5 of the largest per-centre absolute sum. The plain
    # version's index_add_ adds all of them into one f32 cell in turn, so
    # its error is printed, not held to that.
    check(bool((nk == np_).all()) and bool((nk == counts64.float()).all()) and err_k <= 1e-5,
          f"lloyd_step at {n} x {d} bf16, k={k}: counts equal to the plain and float64 "
          f"counts; sums vs float64 rel err {err_k:.2e} (tol 1e-5), plain's {err_p:.2e}")
    del means64, counts64, sums64
    # Bound: x and the centres read once, sums and counts written once;
    # 2nkd operations for the distances and nd adds for the sums.
    b_ms, b_by = bound_ms(n * d * 2 + k * d * 2 + k * d * 4 + k * 8, 2 * n * k * d + n * d,
                          "bfloat16")
    table.append({
        "name": "lloyd_step", "route": "cuda", "source": KMEANS_SOURCE,
        "replaces": REPLACES["lloyd_step"], "launches": km_launches["lloyd_step"],
        "max_abs_err": float((sk - sp).abs().max()),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms, "torch_route_ms": route_l,
    })
    ms = time_ms(lambda: kernels.assign_min_dist(xk, ck), 3)
    plain_ms = time_ms(lambda: kernels.assign_min_dist_plain(xk, ck), 2)
    ik, dk = kernels.assign_min_dist(xk, ck)
    ip, dp = kernels.assign_min_dist_plain(xk, ck)
    same = int((ik == ip).sum())
    check(same == n, f"assign_min_dist at {n} x {d} bf16, k={k}: {same} of {n} indices equal")
    # Bound: x and the centres read once, two (m,) outputs written once.
    b_ms, b_by = bound_ms(n * d * 2 + k * d * 2 + n * 8, 2 * n * k * d, "bfloat16")
    table.append({
        "name": "assign_min_dist", "route": "cuda", "source": KMEANS_SOURCE,
        "replaces": REPLACES["assign_min_dist"], "launches": km_launches["assign_min_dist"],
        "max_abs_err": float((dk - dp).abs().max()),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms, "torch_route_ms": route_a,
    })
    print(f"kmeans kernels at {n} x {d} bf16, k={k}: lloyd_step {table[-2]['ms']:.3f} ms, "
          f"assign_min_dist {ms:.3f} ms; the product alone {lib_ms:.3f} ms; the whole PyTorch "
          f"route (bf16 matmul + first_argmin + index_add_ + bincount) {route_l:.3f} ms, "
          f"(matmul + first_argmin + gather) {route_a:.3f} ms", flush=True)
    del xk, ik, dk, ip, dp, sk, sp
    torch.cuda.empty_cache()

    n, d = xb.shape
    state = lr.init_normal_eq_stats(d, device=DEV)
    ms = time_ms(lambda: kernels.linreg_stats(xb, yb, None, state), 5)
    plain_ms = time_ms(lambda: kernels.linreg_stats_plain(xb, yb, None, state), 3)
    lib_ms = time_ms(lambda: torch.matmul(xb.T, xb), 5)
    out_k = kernels.linreg_stats(xb, yb)
    out_p = kernels.linreg_stats_plain(xb, yb)
    gscale = float(out_p[0].diagonal().max())
    err = rel_err(out_k[0], out_p[0], gscale)
    check(err <= 1e-4 and float(out_k[5]) == float(out_p[5]) == n,
          f"linreg_stats at {n} x {d} bf16: XᵀX rel err {err:.2e} (tol 1e-4), count exact")
    xbd = xb.double()
    g64 = xbd.T @ xbd
    del xbd
    print(f"linreg_stats at {n} x {d} bf16, XᵀX vs float64 (over the largest diagonal entry): "
          f"kernel {rel_err(out_k[0], g64, gscale):.3e}, plain {rel_err(out_p[0], g64, gscale):.3e}")
    promote_sweep(torch, kernels, lambda: kernels.linreg_stats(xb, yb, None, state)[0],
                  lambda: kernels.linreg_stats(xb, yb)[0], g64, gscale, f"linreg_stats {n} x {d}")
    del g64
    # Bound: x and y read once, the state read and written once; XᵀX is
    # symmetric, so nd(d+1) operations, plus 3nd for Xᵀy and Σx.
    b_ms, b_by = bound_ms(n * d * 2 + n * 4 + 2 * (d * d * 4 + 2 * d * 4 + 12),
                          n * d * (d + 1) + 3 * n * d, "bfloat16")
    table.append({
        "name": "linreg_stats", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES["linreg_stats"], "launches": lr_launches["linreg_stats"],
        "max_abs_err": float((out_k[0] - out_p[0]).abs().max()),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms,
    })
    # The in-memory fit's block (one launch per fit), printed beside the row.
    n32 = x32.shape[0]
    ms32 = time_ms(lambda: kernels.linreg_stats(x32, y32), 3)
    plain32 = time_ms(lambda: kernels.linreg_stats_plain(x32, y32), 2)
    lib32 = time_ms(lambda: torch.matmul(x32.T, x32), 3)
    b32, by32 = bound_ms(n32 * d * 4 + n32 * 4 + d * d * 4 + 2 * d * 4 + 12,
                         n32 * d * (d + 1) + 3 * n32 * d, "float32")
    print(f"linreg_stats at {n32} x {d} f32 (the in-memory fit): {ms32:.3f} ms (plain "
          f"{plain32:.3f}, torch.matmul {lib32:.3f}, bound {b32:.3f} by {by32})")
    del xb, yb, x32, y32, out_k, out_p, state
    torch.cuda.empty_cache()

    # -- 11.-12. LogisticRegression at full width --------------------------------
    stamp("phases 11-12")
    xl, yl, model_b, lg_launches = phase_logreg_binary(torch, kernels, lg, LogisticRegression)
    xm, xmh, ym, model_m, pm, mn_launches = phase_logreg_multinomial(
        torch, kernels, lg, LogisticRegression, config)

    # -- 13. transform -------------------------------------------------------------
    stamp("phase 13")
    cd = config.compute_dtype(DEV)
    p50_b = check_transform(torch, model_b, xl[:LG_TRANSFORM_ROWS], cd, "logreg binary")
    p50_m = check_transform(torch, model_m, xm[:LG_TRANSFORM_ROWS], cd,
                            f"logreg multinomial C={MN_CLASSES}")
    print(f"logreg transform {LG_TRANSFORM_ROWS} x {LG_D} (device-resident input, host clock, "
          f"synced): p50 binary {p50_b:.3f} ms, multinomial {p50_m:.3f} ms", flush=True)

    # -- 14. the LogisticRegression kernels at their paths' shapes ----------------
    stamp("phase 14")
    table += phase_logreg_timings(torch, kernels, solve_newton_system, xl, yl, model_b,
                                  lg_launches, xmh, pm, mn_launches)
    del xl, yl, xm, xmh, ym, pm, model_b, model_m
    torch.cuda.empty_cache()

    # -- 15.-18. nearest neighbours ------------------------------------------------
    stamp("phases 15-18")
    table += phase_knn(torch, kernels, config)
    torch.cuda.empty_cache()

    # -- 19. the PCA data plane ------------------------------------------------------
    stamp("phase 19")
    dp_launches, dp_rate = phase_data_plane(torch, kernels, config, scales, mu, fit_pca_stream,
                                            PCAModel)
    torch.cuda.empty_cache()

    # -- 20. the Spark feed protocol from separate processes ----------------------------
    stamp("phase 20")
    sp_launches, sp_rate = phase_spark_feed(torch, kernels, fit_pca_stream, dp_rate)
    torch.cuda.empty_cache()
    row_gc = next(row for row in table if row["name"] == "gram_colsum")
    row_gc["daemon_launches"], row_gc["spark_launches"] = dp_launches, sp_launches

    # -- 21. the iterative daemon jobs through the Spark feed protocol -------------------
    stamp("phase 21")
    for name, n in phase_iterative_jobs(torch, kernels, config).items():
        next(row for row in table if row["name"] == name)["daemon_launches"] = n

    # -- 22. the knn job: the index built and served by the daemon ------------------------
    stamp("phase 22")
    for name, n in phase_knn_daemon(torch, kernels, config).items():
        next(row for row in table if row["name"] == name)["daemon_launches"] = n
    torch.cuda.empty_cache()

    # -- 23. scaler, pipeline, tuning, evaluation; SparkStandardScaler -------------------
    stamp("phase 23")
    for name, n in phase_estimators(torch, kernels, config).items():
        next(row for row in table if row["name"] == name)["estimator_launches"] = n
    row_gc["spark_scaler_launches"] = phase_spark_scaler(torch, kernels, config, sp_rate)
    torch.cuda.empty_cache()

    # -- 24. the histogram RandomForest at the sizes users run ----------------------------
    stamp("phase 24")
    phase_forests(torch, kernels, config)
    torch.cuda.empty_cache()

    # -- 25. the forests through the daemon: SparkRandomForest{Classifier,Regressor} --------
    stamp("phase 25")
    phase_forest_daemon(torch, kernels, config, sp_rate)
    torch.cuda.empty_cache()

    # -- 26. the fits across processes: an NCCL world of one, two gloo ranks --------------
    stamp("phase 26")
    for name, n in phase_multiprocess(torch, card, stream_rate).items():
        next(row for row in table if row["name"] == name)["multiprocess_launches"] = n

    # -- 27. the fits across daemons: two daemons on the card, then two processes ---------
    stamp("phase 27")
    for name, n in phase_multidaemon(torch, kernels, config).items():
        next(row for row in table if row["name"] == name)["multidaemon_launches"] = n

    # -- 28. the elastic fits: a peer lost for good, a daemon joining, chaos ---------------
    stamp("phase 28")
    for name, n in phase_elastic(torch, kernels, config).items():
        next(row for row in table if row["name"] == name)["elastic_launches"] = n

    # -- 29. the serving plane: micro-batching, warmup, health and metrics -------------------
    stamp("phase 29")
    for name, n in phase_serving(torch, kernels, config).items():
        next(row for row in table if row["name"] == name)["serving_launches"] = n

    # -- 30. the observability plane: the journal across processes, the kernel ledger -------
    stamp("phase 30")
    for name, n in phase_telemetry(torch, kernels, config).items():
        next(row for row in table if row["name"] == name)["telemetry_launches"] = n

    # -- 31-32. durable daemons, the routed fleet and its control plane -----------------------
    stamp("phases 31-32")
    torch.cuda.empty_cache()
    for (part, name), n in phase_fleet(torch, kernels, config).items():
        next(row for row in table if row["name"] == name)[f"{part}_launches"] = n

    # -- 33. the model axis: the feature-sharded Gram and the sharded IVF index -------------
    stamp("phase 33")
    for name, n in phase_model_axis(torch, kernels, config).items():
        next(row for row in table if row["name"] == name)["model_axis_launches"] = n

    # -- 34. srml-check on this host; the daemon loads its kernels before it listens ----------
    stamp("phase 34")
    phase_analyze(torch, kernels, config)
    for row in table:
        row["design"] = DESIGNS.get(row["name"], "wgmma+tma syrk")
        print(f"{row['name']} [{row['design']}]: {row['ms']:.3f} ms (plain {row['plain_ms']:.3f}, "
              f"library {row['library_ms']:.3f}, bound {row['bound_ms']:.3f} by "
              f"{row['bound_by']}), {row['launches']} launches on the main path")
    stamp("total")
    print(card)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
