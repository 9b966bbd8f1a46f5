"""Smoke run of grakel_torch on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``grakel_torch/csrc`` and drives its
main paths through the public entry points, at full data size:

* WL-VH: ``WeisfeilerLehman(n_iter=5)`` (VertexHistogram base)
  ``fit_transform`` on the 4110-graph NCI1-scale set of ``bench.py``
  (``generate_dataset``, seed 1234, 37 labels), then ``transform`` of
  held-out graphs.  Its Grams must equal the same calls under
  ``use_device("cpu")`` and its diagonal must equal ``diagonal()``;
* PyramidMatch (``with_labels=False``, L=4, d=6) ``fit_transform`` on a
  2000-graph REDDIT-B-scale stand-in (the heavy-tailed generator of
  ``tools/full_bench.py``, copied below), and labeled PyramidMatch on the
  NCI1-scale set.  Each Gram must equal the level Grams recomputed with
  the plain min-intersection from the same histograms, combined the same
  way;
* ShortestPath, the slice of K3: ``GraphKernel(kernel="shortest_path")``
  ``fit_transform`` on the 4110 NCI1-scale graphs and ``transform`` of
  the 64 held-out ones (the direct-index route); the same kernel on 1024
  weighted NCI1-scale graphs (the hash route); WL-SP
  (``[{"name": "WL", "n_iter": 5}, "shortest_path"]``) and CoreFramework-SP
  on the 4110 graphs and the 64 held-out ones; SP and CoreFramework-SP on
  MUTAG read with ``read_data`` from ``tests/data``; unlabeled SP on the
  REDDIT-B-scale stand-in's graphs of 129-512 vertices (fit 96,
  transform 16: unit weights past V = 128, K3's blocked route, on every
  call).  Every Gram must equal the same calls under
  ``use_device("cpu")``;
* ShortestPath's stream mode (``sp_stream_phase``): unlabeled
  ``GraphKernel(kernel={"name": "shortest_path", "with_labels":
  False})`` on the REDDIT-M-12K stand-in (the generator below with
  ``tools/full_bench.py:80-82``'s parameters, seed 1234: all 11,929
  graphs fit, 64 more drawn with seed 1235 transformed; not cut;
  ``sp_stream_redditm12k``): the fit parse must take stream mode (no
  dense bucket built) and the BFS route, and its Grams and Y's diagonal
  must equal, bit for bit, the f64 product of a count matrix the smoke
  builds itself from the native engine's stream, and the CPU's on the
  first 1000 graphs; the slab route (``_STREAM_BFS = False``) on the
  stand-in's graphs of at most 512 vertices among its first 2000
  (``sp_stream_slab``): K3 once a slab, the Grams equal to the BFS
  route's and dense mode's; and labeled SP on the DD stand-in
  (``tools/full_bench.py:65-67``, 82 labels, an unseen one planted in
  the transform set; ``sp_stream_dd``): stream mode, the BFS route
  over compacted keys, equal to dense mode on the card.  Each path's
  stages, BFS seconds and peak device memory are printed;
* NeighborhoodHash, the slice of K4 and K5: ``GraphKernel(kernel="NH",
  random_state=0)`` (R = 3, bits = 8), ``simple`` (``nh_nci1scale``) and
  ``count_sensitive`` (``nh_cs_nci1scale``), ``fit_transform`` on the
  4110 NCI1-scale graphs and ``transform`` of the 64 held-out ones; and
  ``WeisfeilerLehmanOptimalAssignment(n_iter=5)`` on the same graphs
  (``wloa_nci1scale``).  Every Gram must equal the same calls under
  ``use_device("cpu")`` bit for bit;
* HadamardCode and Propagation, the slice of K6: ``HadamardCode(n_iter=5)``
  (VertexHistogram base, the fast path) ``fit_transform`` on the 4110
  NCI1-scale graphs and ``transform`` of the 64 held-out ones, whose
  planted unseen label takes a Hadamard row no fit vertex has (37 labels
  stay within D = 64; ``hc_nci1scale``: K6's graph route once a call,
  its round route never);
  HadamardCode with a ShortestPath base on MUTAG read with ``read_data``
  (``hc_sp_mutag``, the host path: K3, no K6); ``Propagation(random_state
  =0)`` (TV, t_max = 5, w = 0.01) on the NCI1-scale set, whose transform
  runs the unseen-label branch (``prop_nci1scale``); and
  ``PropagationAttr(random_state=0)`` on Cuneiform read with
  ``read_data`` (real attributes; ``propattr_cuneiform``).  Every Gram,
  transform and diagonal must equal the same calls under
  ``use_device("cpu")`` bit for bit;
* the native host layer (no hand kernel; the C++ engines build with
  ``g++`` into ``build/native/`` beside the CUDA kernels):
  ``OddSth()`` (``oddsth_nci1scale``) and ``GraphKernel(kernel={"name":
  "NSPD", "r": 3, "d": 4})`` (``nspd_nci1scale``) ``fit_transform`` on the
  4110 NCI1-scale graphs and ``transform`` of the 64 held-out ones, and
  ``SubgraphMatching(k=5)`` on MUTAG read with ``read_data``, fit 40,
  transform 10 (``sm_mutag``; cut: a host loop of ~2 ms a pair).  Their
  Grams, transforms and diagonals must equal the same calls under
  ``use_device("cpu")``: OddSth's and SubgraphMatching's bit for bit,
  NSPD's f64 products to rtol 1e-12.  OddSth's shared-column Gram (the
  chunked counts-Gram, beside ``torch.sparse.mm``, which must agree),
  NSPD's fit Gram with its f64 dense block and its transform Gram over
  the touched fit columns (beside the per-level chunk loop it replaced,
  which must agree to rtol 1e-6), each the path's own call with the
  arguments the path gives it, are timed beside their bounds; the native engines are held against
  their Python versions on MUTAG (OddSth and NSPD Grams, ``clique_values``
  on SM product graphs, ``ap_hash_batch``);
* GraphletSampling, RandomWalk and RandomWalkLabeled, the slice of K7,
  K8 and K9: ``GraphletSampling(k=5, sampling={"n_samples": 150},
  random_state=42)`` on the 4110 NCI1-scale graphs and the 64 held-out
  ones (``gs_nci1scale``, host-bound: run once on the card and once on
  the CPU; K7 once a graphlet size, 3, 4 and 5, in fit_transform and in
  transform), exhaustive ``GraphletSampling(k=5)`` on MUTAG read with
  ``read_data``, fit 150, transform 38 (``gs_mutag``: the native ESU,
  K7 at s = 5), ``RandomWalk()`` on the NCI1-scale set (``rw_nci1scale``:
  rho = lamda max|mu|^2 past 0.9, so the spectral tile route: K9 exactly
  once a Gram call, 3 a run (fit, transform, the transform's diagonal);
  rho and the plan's tiles printed) and ``RandomWalkLabeled()`` on MUTAG,
  fit 150, transform 38 (``rwl_mutag``: K8's labeled CG, only its warp
  route, at buckets 16 and 32, one launch a bucket pair a Gram).  Grams, transforms and diagonals must equal the
  same calls under ``use_device("cpu")``: GraphletSampling's bit for bit,
  RandomWalk's f64 tiles to rtol 1e-8 (f64 sums in another order),
  RandomWalkLabeled's f32 CG to rtol 1e-4;
* SvmTheta, LovaszTheta, GraphHopper and MultiscaleLaplacian, the slice
  of K10-K14 (``slice_theta_phase``): ``SvmTheta(random_state=42)``
  (``svmtheta_nci1scale``; K10 and K11 in one launch a size bucket a
  parse, no dense K and no ``torch.linalg.eigvalsh`` on the card) and
  ``LovaszTheta(random_state=42)`` (``lovasz_nci1scale``; 300 K12 and
  301 K14 launches a size bucket a parse, K14 from the step before's
  eigenvectors at steps 2-300, K13 once a parse) on the 4110 NCI1-scale
  graphs and the 64 held-out ones, ``GraphHopper()`` (``gh_cuneiform``, the linear Gram
  one f64 GEMM on the card) and ``MultiscaleLaplacian(random_state=42)``
  (``ml_cuneiform``, host numpy) on Cuneiform read with ``read_data``,
  fit 200, transform 67.  Against ``use_device("cpu")``: SvmTheta to
  rtol 2e-2 on its first 512 fit and 16 held-out graphs (f32 solves:
  the shifted K is singular, so the one-class minimizer may be a set,
  and two f32 trajectories stop at different points of it: 1.28e-2 at
  full size on an H100; cut: the CPU's solve takes ~15 s at full
  size), LovaszTheta to rtol 2e-2 on its first 64 fit and 8
  held-out graphs (cut: the CPU's SDP and cone loop take minutes at
  full size; the card's eigendecomposition differs from LAPACK's in the
  last bits and the cone iteration resolves exact ties by them),
  GraphHopper to rtol 1e-10 (an f64 GEMM), MultiscaleLaplacian bit for
  bit on fit 30, transform 10 (cut: ~11 s a run at full size);
* the multi-GPU layer (``parallel_phase``) on a one-rank NCCL mesh made
  by ``grakel_torch.parallel.make_mesh()`` (a world of one, no
  launcher; its set-up and first all-gather timed):
  ``distributed_wl_gram(graphs, 5, mesh)`` on the 4110 NCI1-scale
  graphs, not cut (``dist_wl_nci1scale``), then WL's transform of the
  64 held-out graphs under ``use_mesh``; ``LargeGraphWL(n_iter=5,
  mesh=mesh)`` on the NCI1-scale set plus one graph at ogbn-arxiv's
  size (169,343 vertices, 1,166,243 undirected edges drawn uniformly
  from the seed, 40 labels; ``large_wl_arxiv``): the big graph on K2's
  second reach (``wl_hash_refine_rows``), the rest on its first, once
  a generation a call.  Each Gram and transform must equal
  ``WeisfeilerLehman(n_iter=5)``'s on the card bit for bit, and
  ``LargeGraphWL`` under ``use_device("cpu")`` (a gloo world of one)
  the card's on a cut: a 50,000-vertex graph among the first 100
  graphs (a CPU run of the full set is not needed to hold the route);
* ``cross_validate_Kfold_SVM`` (``cv_phase``), the slice of K15 and K16
  (``csrc/csvc.cu``: libsvm's SMO, one launch a route a stage, a warp a
  problem up to ``K15_WARP_ROWS`` rows, a block a problem past it; the
  one-vs-one vote, a block a run of eval points of a vote group):
  ``cv_nci1scale`` (WL-VH h=5, normalized, on the 4110 NCI1-scale
  graphs, two classes from their label shares with 20 % flipped, the
  default protocol: 700 inner fits of 3329 rows, 100 refits of 3699, the
  block route), ``cv_mutag`` (WL h=5 on MUTAG, ``docs/accuracy.md``'s
  protocol, the block route; its scores must equal the JAX package's,
  embedded as ``CV_MUTAG_JAX``, and the CPU route's) and
  ``cv_cuneiform`` (GraphHopper on Cuneiform, 30 classes, the same
  protocol, the warp route; equal to the CPU route on a cut: one
  iteration, C up to 10).  Each launches K15 once a route a stage (one
  route each) and K16 once a stage; K15 and K16 must equal
  ``smo_plain`` and ``vote_plain`` bit for bit on ``cv_nci1scale``'s
  first outer fold (7 inner fits, its refit) and on the ``cv_cuneiform``
  inner fit that holds the stage's longest problem (K16 on all its
  pairs, K15 on its four pairs of the most iterations, the plain version
  in a worker process while the other paths run); each stage's longest
  problem is timed alone (its critical path).  ``SVC.fit``,
  ``SVC.predict`` and the CV must raise scikit-learn's error on a Gram
  with a NaN or an infinity before any K15 or K16 launch.  K15's warp
  route limit is swept on Cuneiform's and MUTAG's inner stages, its
  block route at 448-512 threads on NCI1's first fold and inner stage,
  and its global route run on that fold, each equal bit for bit to the
  path's launch.  ``cv_nci1scale_auc`` is ``cv_nci1scale`` scored by
  ``"roc_auc"``, read from K16's decision values: the same launches, 10
  finite scores in [0, 1], and the first outer fold's refit score equal
  to roc_auc of ``vote_plain``'s decision values on the CPU;
  ``cv_mutag_scorers`` runs ``cv_mutag`` at one iteration once for each
  of the other 30 scoring names, each name's scores (or its error) equal
  to the JAX package's, embedded as ``CV_MUTAG_SCORERS_JAX`` (adjusted
  mutual information to rtol 1e-12), with K15 and K16 once a stage.
  ``python3 chip_smoke.py --phase cv`` runs the build and this phase
  alone.
* the float64 normalization on the card (``gram_norm_phase``, K17):
  ``wl_norm_nci1scale`` (WL-VH h=5 normalized on the 4110 NCI1-scale
  graphs) launches K17 once and equals its f32 Gram normalized on the
  host bit for bit; K17 alone on that Gram in f32 and f64 against the
  host route, timed beside its bytes bound, the host route and the
  pageable fetch of both widths.  ``python3 chip_smoke.py --phase
  gram_norm`` runs the build and this phase alone.

Every kernel's launch count is set to 0 just before a path and read just
after it.  WL-VH must launch K2 (``wl_hash_refine``), unlabeled PM the
CUDA-core K1 (``min_gram``) exactly once (its four levels weighted and
concatenated into one call) and no K1-tc, labeled PM the kernels its
levels' routes name (``ops.intersect.min_gram_route``: one K1 call for
the levels that take K1, ONE K1-tc call and one expansion launch,
``threshold_expand``, for all the other levels, each column weighted by
its level's integer weight; with every level on K1-tc, K1-tc exactly
once), and
every ShortestPath path K3 (``floyd_warshall``), ``hc_nci1scale`` K6's
graph route (``hadamard_graph``) once in fit_transform and once in
transform and its round route (``hadamard_step``) never, the other
HadamardCode / Propagation paths neither, each NH path K4 once a
parse on its graph route (``nh_graph``; no launch of its round route
``nh_round``), K5 (``jaccard_fold``) once a Gram (the fit Gram on its
triangle route, the transform's on its rect route), one K1 call a
round routed to K1 and ONE K1-tc launch a Gram for the rounds routed to
K1-tc (printed with each round's W'/L; K1-tc twice a path), with one
expansion launch a side.  The unlabeled PM Gram
stage (K1 and the torch ops up to the f64 result) is then timed and
profiled as it runs, one fused K1 call, beside the same stage with one
K1 call and a torch fold per level.  WL-VH, the PM paths and SP on the NCI1-scale set
and on the REDDIT-B-scale graphs then run again, warm (WL-VH twice,
each SP path 3 times; median reported; the PM paths not), and once
more under ``torch.profiler`` for their device busy time, idle share
and longest device activities.

Then each kernel is held against its plain PyTorch version on the card
at the shapes the paths gave it, and timed beside its bound, its plain
version and a library yardstick: ``ms``, device time from CUDA events
with the stream kept busy while the calls are enqueued; ``device_ms``,
the kernel's own records in torch.profiler; ``wrapper_ms``, the host
time of a call:

* K1 at the call the unlabeled PM path makes (2000 x 2000 x 90, the
  weighted levels concatenated, symmetric: the block triangle), at each
  unlabeled level alone (symmetric), at the labeled levels, square
  (symmetric, as fit_transform) and at the transform shape of a 10-fold
  split (411 x 3699), for the break-even ratio of the two routes; integer
  inputs exactly, a ragged real-valued case to rtol=1e-5, atol=1e-4 (the
  f32 sum order differs), the triangle against the full rectangle at a
  ragged n and at n = 1, and the alpha / accumulate epilogue.  Every
  shape of the path and of the labeled levels is timed at each tile
  instantiation (``tile_sweep``, each checked bit for bit), and K1's
  kernels must build without spills.  Bound: the larger of bytes (the
  inputs once, the output once, read once more when accumulating) over
  3.35 TB/s and operations (2 L per distinct entry: n (n + 1) / 2 when
  symmetric) over 67 TFLOP/s fp32; yardstick ``torch.cdist(p=1)``
  (sum_l min(a, b) = (sum a + sum b - |a - b|_1) / 2);
* K1-tc as the entry points call it, the expansion kernel included
  (one launch a side; one for a symmetric weighted call's weighted and
  0/1 indicators): the labeled PM fit_transform call (its levels
  concatenated, each column weighted by its level's integer weight, one
  launch, symmetric: the tiles on or above the diagonal) and the same
  fused form at the transform shape of a 10-fold split (411 x 3699);
  each labeled level alone (symmetric and at the transform shape), for
  the earlier per-level mma.sync design, kept as
  ``csrc/min_gram_tc_mma.cu`` and timed beside on the same inputs, and
  for the break-even ratio against
  K1; the NH simple path's two calls (its fit Gram's three rounds,
  4110 x 4110 over L = 256, in one launch, and its transform's, 3 x 64
  x 4110, with a sweep of every tile instantiation), the mma.sync design (one
  launch a round) beside; a ragged rectangular case, unweighted and
  weighted, and a weighted symmetric one.  Each is held against its
  plain version exactly, with the alpha / accumulate epilogue, and the
  expansion against its plain version bit for bit.  Bound: the larger
  of the products the function needs (2 W' per Gram entry, n (n + 1) /
  2 distinct entries when symmetric, every round) over 1979 TOP/s int8
  and the int8 indicators plus the f32 output over 3.35 TB/s (the fused
  call's, and the per-level count: each level's indicators and Gram);
  yardstick ``torch._int_mm`` on the same indicators (the port never
  calls it; it computes the full square, one call a round).  K1-tc's 4
  instantiations, the expansion and the mma.sync kernel must build without
  spills;
* K2 over the NCI1-scale batch's CSR, generations 0-2, keys and the
  hashes unpacked from them bit-identical to the plain versions; its
  wrapper's host time per call beside; its second reach on the
  arxiv-sized graph's CSR in four row blocks, one launch each as four
  ranks run a generation: the keys concatenated equal to reach 1 over
  the whole graph and to the plain version bit for bit, timed (CUDA
  events, and reach 1 over the whole graph beside) against its bound
  (each block's CSR, the gathered labels read once a block, the keys
  written once, over 3.35 TB/s);
* K3 at each NCI1-scale bucket of the SP fit (route tile: register
  micro-tiles, several graphs per block; each row names the route and
  the instantiation T, G the call took, and a sweep over every (T, G)
  that fits the bucket is timed beside), at the weighted fit's buckets
  and a weighted V = 96 batch (route tile), on large float-weighted
  graphs (route per_k, one launch per k: 4 at V = 512, 1 at V = 1000),
  on large integer-weighted graphs (route blocked, the same shapes), at
  the REDDIT-B-scale path's buckets (route blocked) and on each slab of
  ``sp_stream_slab``'s fit parse, each bit-identical to
  ``floyd_warshall_plain``, and on one slab of the REDDIT-M-12K
  stand-in's top bucket (V = 3784; its counts held against the BFS
  engine's, the whole slab step timed beside).  K3's kernels must build
  without spills (``-Xptxas -v``).  Bound: the larger of 2 n V^3
  operations over 67 TFLOP/s fp32 and adj, mask and S moved once over
  3.35 TB/s.  No single PyTorch call computes APSP: no library time;
* K4 through ``ops.nh.nh_rounds`` (the call a parse makes), both hash
  types, R rounds bit-identical to ``ops.nh.nh_rounds_plain``, on each
  route, which the launch counts must confirm: the graph route on the NH
  paths' batches (the fit graphs, with a sweep of chunk sizes, and the
  held-out graphs, whose planted unseen label poisons nodes; the fit
  graphs also with a sweep of the hub degree) and on the
  REDDIT-B-scale stand-in's 2000 graphs labeled by vertex degree (hubs
  of degree up to ~230, folded by a warp); the round route on six graphs
  of 5500-6500 vertices (ROADMAP's WL inputs); both in one batch of 150
  NCI1-scale graphs and those six.  The graph route must write every bin
  of a stack of garbage and the call must run no fill kernel.  Bound:
  the bytes the call must move (each node's label, validity, graph id
  and offset and each edge's target read once, the R histograms written
  once) over 3.35 TB/s; the earlier count (every round's node and edge
  traffic) beside it;
* K5 on the NH paths' per-round counts on each route: the fit Gram's
  (symmetric 4110 x 4110) on the triangle route the path takes and on
  the pair route, the transform's (64 x 4110) on the rect route,
  bit-identical to ``ops.intersect.jaccard_fold_plain`` and to the
  paths' Grams; the triangle route must give the same ratios with the
  tiles below the diagonal set to NaN.  Bound: the counts it must read
  (R n (n + 1) / 2 on the triangle route, R n m otherwise), the vertex
  counts and the n m ratios written, over 3.35 TB/s; the earlier count
  (the full square) beside it.  No single PyTorch call computes K4 or K5: no
  library time;
* K6 through ``ops.hadamard.hadamard_generations`` (the call
  HadamardCode's fast path makes), the keys of all five generations
  bit-identical to ``ops.hadamard.hadamard_generations_plain``, on the
  routes ``ops.hadamard.hc_plan`` picks (the launches per route must
  match): the ``hc_nci1scale`` fit batch (its own table, D = 64; graph
  route, with the earlier design timed beside (the round route over
  every row, five launches), the planner alone and a sweep of
  the shared memory budget timed beside) and its transform batch (tags
  Dx and Dt), random tables of width D = 1, 2, 8, 32, 64, 128 (graph
  route) and 1024 (mostly the round route) on the fit batch, the
  REDDIT-B-scale stand-in (out-degrees to 226) at D = 1 (graph route)
  and 64 (its large graphs on the round route, mixed), and a row a node
  over the whole int32 range whose sums wrap.  Its 14 kernels must build
  without spills.  Bound: the larger of the bytes the call must move
  (each valid node's row index, tag and offset, each edge's target and
  the table read once, the keys written once) over 3.35 TB/s and ~24
  integer operations an element a generation over the INT32 pipe's rate
  (132 SMs x 64 lanes x 1.98 GHz); the earlier per-generation count and
  the same count at 67 TOP/s beside it; no PyTorch call computes the
  hash (no library time), the int32 ``index_add_`` of the neighbours'
  rows (the neighbour sum alone) is timed beside;
* ``min_intersection_gram_rounds`` (the Pallas kernel's second reach, R
  K1 calls) on the simple path's fit stack (symmetric, exact) and on a
  ragged real-valued rectangular stack (rtol=1e-5, atol=1e-4) against R
  ``min_gram_plain`` calls, beside R ``torch.cdist(p=1)`` calls: K1's
  ``rounds`` entry;
* K7 (``ops.canonical.canonical_codes_cuda``) at the three calls of the
  ``gs_nci1scale`` fit parse and on 100,000 random graphlets at each size
  s = 2..8 (at s = 8 with the table in shared memory and read through
  L1, both timed), bit-identical to ``canonical_codes_plain``; bound:
  s! permutations a graphlet of 3 integer operations a column and one
  for the minimum, over the INT32 pipe's rate (132 SMs x 64 lanes x
  1.98 GHz), the earlier count (3 operations a bit read, s(s-1)/2 bit reads
  a permutation) beside at that rate and at 67 TOP/s; and an
  instruction floor: the INT32-pipe instructions a permutation takes in
  the built walk (``cuobjdump -sass``) times s! a graphlet over the
  INT32 issue rate;
* K8 (``ops.random_walk.pair_cg_cuda``) at every call of the
  ``rwl_mutag`` path (graph tables, pairs as table rows; the warp
  route), on directed NCI1-scale pairs (``RandomWalk(lamda=0.01)``, and
  ``RandomWalk()``'s lamda 0.1, where the series diverges; warp and
  shared routes), on labeled NCI1-scale pairs (warp and shared) and on
  the REDDIT-B stand-in's graphs of 65-256 vertices labeled by degree
  (the global route), each to rtol 1e-4 of ``pair_cg_plain`` on every
  pair; at lamda 0.1 on the directed pairs only on those whose plain CG
  froze and lies within 1e-5 of its f64 evaluation (the rest are
  counted: f32 CG may amplify their rounding without limit); launches
  by route printed; its 8 kernels must build without spills.  Bound:
  the flops of the steps each pair ran (2 n1 n2 (n1 + n2) a matvec,
  labeled or not, 12 n1 n2 of vector work) over 67 TFLOP/s fp32;
* K9 (``ops.random_walk.spectral_gram_cuda``) on the ``rw_nci1scale``
  fit Gram's one launch over its plan, within 1e-12 of each entry's sum
  of |terms| of ``spectral_gram_plain`` and exactly symmetric; timed
  (CUDA events around the wrapper, and the kernel's profiler record).
  Bound: 4 f64 operations a term of the distinct pairs the Gram needs
  over 34 TFLOP/s, beside the same count over PR 11's launched tiles;
  and an instruction floor: the FP64 instructions a term takes in the
  kernel's built inner loop (``cuobjdump -sass``) times the launched
  terms over the FP64 issue rate.  No single PyTorch call computes K7,
  K8 or K9: no library time;
* K10 and K11 (``ops.svm_qp.solve_cuda``: one launch a size bucket on
  K's bit rows) on each bucket of the ``svmtheta_nci1scale`` fit parse
  as the path launched it, on route "block" on its widest bucket and on
  a V = 256 bucket of the REDDIT-B stand-in (its own route "block"), each
  kernel timed alone (``lanczos_cuda``: Lanczos on, iters = 0;
  ``fista_cuda``: Lanczos off) and the launch whole (``fused_ms``), which
  must equal K10 alone and then K11 alone bit for bit.  K10 against
  ``lanczos_bits_plain`` (``lanczos_plain`` a slab at a time on the
  dense K): the first three alphas and the shift from its coefficients
  to 1e-4; K11 on K10's coefficients against ``spectral_shift`` +
  ``fista_plain``: K a and the objective a^T K a (unique at the
  optimum; the alphas may differ along a minimizer set) to 1e-4, the
  alphas feasible to 1e-4 and to 1e-3 of ``fista_plain``'s on the
  kernel's own shift, the tridiagonal's extremes to 1e-6 of the largest
  |eigenvalue| of f64 ``eigvalsh``'s and to 1e-4 of the plain version's
  f32 ``eigvalsh`` (timed beside K11 as ``shift_library_ms``: it is the
  shift's part alone, so K11 has no library time).  Bounds: K10's and
  K11's with K x as K's nnz adds, the bit rows read once (K is 0/1;
  beside each the dense count, ``bound_ms_dense``); K10's row also
  gives the step's chain in the built kernels (``step_chain``: the
  shuffles and MUFU operations of the Lanczos loop of
  ``svm_solve_warp<V>``, ``cuobjdump -sass``); K12
  (``ops.lovasz_sdp.dr_step_cuda``, on the edges' bit rows) on each size
  bucket's DR state at its 150th step of the ``lovasz_nci1scale`` fit
  parse, route "tile" there and route "global" on the widest bucket, Y,
  X and R to 1e-4 (bound: 6 V^2 + V^2 / 8 floats a graph moved against
  2 V^3 + 12 V^2 flops; the count with the edges as floats, 7 V^2, beside
  it), a bucket at a time, with the eigendecomposition's time beside it
  and each fit bucket's 300-step DR solve timed; K13 (``min_cone_cuda``)
  on the fit parse's subsets to 1e-5 on its route "register" and on the
  first 20,000 of them on every route (bound: 3 d m + 3 d flops a step),
  and its quotient (the f32 reciprocal of k + 2 and two fused
  corrections) against ``__fdiv_rn`` bit for bit on every f32 in [-2, 2]
  and every divisor 2 .. 401 (``ops.lovasz_sdp.min_cone_quotient_check``);
  K14 (``jacobi_eigh_cuda``) on the same DR reflections, from
  step 149's eigenvectors as the path runs it and from the identity, and
  on random matrices with half their rows padded, from the identity and
  from a random orthogonal basis, against ``torch.linalg.eigh`` (its
  plain version and the one library call): sorted eigenvalues and PSD
  projections to 1e-4 of the largest |eigenvalue|, U orthogonal to 1e-4,
  also after the path's 300 steps of rotations (bound: 9 V^3 flops a
  matrix, the dense direct method's count); each fit bucket's DR solve
  run again with K14's sweeps logged step by step, and the DR solve of
  a V = 128 bucket (64 REDDIT-B stand-in graphs of 65-128 vertices),
  which the NCI1-scale buckets never reach, with U's orthogonality and
  K14's accuracy at its step 300.  Their 26 kernels (K10 and K11 5,
  each running both; K12 7, K13 12, K14 2) must build without spills;
* K15 and K16 (``ops.csvc.smo_cuda``, ``vote_cuda``) on
  ``cv_nci1scale``'s inner fits as the path launched them (700
  problems, 370 eval points each; each stage of each ``cv_*`` path is
  run again under torch.profiler, and its kernel records give the
  device ms by route, without the wrappers' host work), against their
  plain versions on the first outer fold (above).  K15's bound: its
  inputs read and outputs written once against 4 f64 operations (the G
  update's two products and two sums) an active row an iteration, at 34
  TFLOP/s, with the count of two Q rows of l f32 entries read an
  iteration beside it (``bound_ms_q_rows``), and its critical path (the
  longest problem alone); K16's: each needed Gram entry once against a
  product and a sum a nonzero coefficient an eval point.  No single
  PyTorch call solves an SVM: no library time.  Their nine kernels must
  build without spills.

NVIDIA's H100 SXM figures.  Output, on separate lines: the card, the
build, a ``{"paths": ...}`` JSON line, a ``{"kernels": [...]}`` JSON
line, the seconds the whole run took, the ``nvidia-smi`` name and power
limit, and last ``{"ok": true, "device": {...}}``.  Exits non-zero, with no result line, without a CUDA
card, outside the repository, or when any check fails.
"""

from __future__ import annotations

import json
import os
from collections import Counter
import re
import subprocess
import sys
import time
import warnings

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

N_GRAPHS, N_LABELS, SEED, N_HELD = 4110, 37, 1234, 64
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_OPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
# H100 SXM INT32 pipe: 64 lanes a clock an SM (NVIDIA's Hopper white
# paper), 132 SMs, at the maximum SM clock of 1980 MHz
INT32_OPS_PER_S = 132 * 64 * 1.98e9
INT8_OPS_PER_S = 1979e12       # H100 SXM int8 tensor cores, dense
FP64_OPS_PER_S = 67e12         # H100 SXM fp64 tensor cores (DGEMM)
FP64_VECTOR_OPS_PER_S = 34e12  # H100 SXM fp64 outside the tensor cores
REDDIT_B = dict(n_graphs=2000, median=304, mean=429.63, vmax=3782,
                edge_ratio=1.1585)
# tools/full_bench.py:80-82 and 65-67 (DD: 82 node labels)
REDDIT_M12K = dict(n_graphs=11929, median=280, mean=391.41, vmax=3782,
                   edge_ratio=1.1673)
DD = dict(n_graphs=1178, median=241, mean=284.32, vmax=5748,
          edge_ratio=2.517)
DD_LABELS = 82


def heavy_tailed_graphs(n_graphs, median, mean, vmax, edge_ratio, seed):
    """REDDIT-shaped stand-in (copy of tools/full_bench.py
    _heavy_tailed_graphs without its COLLAB branch): lognormal sizes
    truncated at the published maximum, a preferential-attachment tree
    plus uniform extra edges up to ``edge_ratio * n``.  Returns
    (n, src, dst) COO graphs, undirected, both directions."""
    rng = np.random.RandomState(seed)
    sigma = np.sqrt(max(2.0 * np.log(mean / median), 1e-4))
    sizes = np.minimum(np.maximum(rng.lognormal(
        np.log(median), sigma, n_graphs), 6).astype(np.int64), vmax)
    for _ in range(8):
        err = mean / max(sizes.mean(), 1.0)
        if abs(err - 1.0) < 0.005:
            break
        sizes = np.minimum(np.maximum(
            (sizes * err).astype(np.int64), 6), vmax)
    out = []
    for n in sizes:
        n = int(n)
        parents = np.zeros(n, np.int64)
        if n > 1:
            draws = rng.randint(0, 2 * n, n)
            ends = np.zeros(2 * n, np.int64)
            ne = 0
            for v in range(1, n):
                p = int(ends[draws[v] % ne]) if ne else 0
                parents[v] = p
                ends[ne] = v
                ends[ne + 1] = p
                ne += 2
        s = np.arange(1, n, dtype=np.int64)
        d = parents[1:]
        extra = int(max(0, round(edge_ratio * n) - (n - 1)))
        if extra:
            es = rng.randint(0, n, extra)
            ed = rng.randint(0, n, extra)
            keep = es != ed
            s = np.concatenate([s, es[keep]])
            d = np.concatenate([d, ed[keep]])
        lo = np.minimum(s, d)
        hi = np.maximum(s, d)
        pairs = np.unique(lo * np.int64(vmax + 1) + hi)
        lo = (pairs // (vmax + 1)).astype(np.int32)
        hi = (pairs % (vmax + 1)).astype(np.int32)
        out.append((n, np.concatenate([lo, hi]), np.concatenate([hi, lo])))
    return out


def ptxas_info(text):
    """{kernel: {registers, smem, stack, spill_stores, spill_loads}} from
    ``nvcc -Xptxas -v`` output; a K3, K1 or K10-K14 kernel is named by
    its function and template arguments (``fw_tile<4>``,
    ``min_gram_kernel<64,8,4>``, ``lovasz_min_cone<56,1>``,
    ``csvc_smo_block<4,1024>``), another by its mangled name."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            k = re.search(r"(fw_[a-z]+|min_gram_kernel|"
                          r"(?<=\d)svm_solve_[a-z]+|"
                          r"(?<=\d)lovasz_(?!cu_)[a-z_]+|"
                          r"(?<=\d)csvc_[a-z_]+)"
                          r"(I(?:L[ib]\d+E)+E)?", m.group(1))
            args = re.findall(r"L[ib](\d+)E",
                              (k.group(2) or "") if k else "")
            cur = m.group(1) if k is None else k.group(1) + (
                "<%s>" % ",".join(args) if args else "")
            out[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[cur].update(stack=int(m.group(1)),
                            spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out[cur]["static_smem"] = int(m.group(1)) if m else 0
    return out


class Checks:
    def __init__(self):
        self.failed = []

    def __call__(self, ok, what):
        print("%s: %s" % ("ok  " if ok else "FAIL", what), flush=True)
        if not ok:
            self.failed.append(what)


def cuda_ms(fn, reps, warmup=1, busy_cycles=50_000_000):
    """Mean device milliseconds of ``fn()`` on the current stream: CUDA
    events around ``reps`` back-to-back calls, after ``warmup`` calls.  A
    sleep kernel (``busy_cycles``, ~25 ms by default) keeps the stream
    busy while the host enqueues the calls, so a call that does not wait
    for the device is timed by its device work, not by its host side
    (:func:`host_ms`), as long as the sleep outlasts the enqueueing."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(busy_cycles)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def host_ms(fn, reps):
    """Mean host milliseconds of ``fn()`` over ``reps`` calls that do not
    wait for the device (the wrapper's own cost)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def profiled(fn):
    """Run ``fn()`` once under torch.profiler.  Returns (wall s, device
    busy ms = union of the CUDA activity intervals, {activity name: ms},
    {activity name: count}), or (wall s, None, {}, {}) when the profiler
    saw no CUDA activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    spans, by_name, counts = [], {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            a, b = e.time_range.start, e.time_range.end
            spans.append((a, b))
            by_name[e.name] = by_name.get(e.name, 0.0) + (b - a) / 1e3
            counts[e.name] = counts.get(e.name, 0) + 1
    if not spans:
        return wall, None, {}, {}
    busy, end = 0.0, -1.0
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return wall, busy / 1e3, by_name, counts


def kernel_records(fn, reps, want=()):
    """torch.profiler's CUDA records over ``reps`` calls of ``fn()``:
    ({name: total ms}, {name: count}).  The profiler has left out up to
    a few dozen of a session's kernel records on an H100, all of them in
    short sessions; 64 short spin kernels before the calls and after
    them, each batch waited for, take that loss instead.  A session has
    still kept no record of the kernel measured (a K5 call, now and
    then): when no record's name holds one of ``want``, the session is
    run again, at most four times."""
    import torch

    def pad():
        for _ in range(64):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()

    def run():
        pad()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        pad()

    fn()
    for _ in range(5):
        _, _, by_name, counts = profiled(run)
        if not want or any(w in k for k in by_name for w in want):
            break
    return by_name, counts


def device_ms(fn, reps, kernel, per_call=1):
    """Device milliseconds a call of ``fn()`` spends in the CUDA kernel
    whose name contains ``kernel``, launched ``per_call`` times a call,
    from torch.profiler over ``reps`` calls: the kernel records' mean
    times ``per_call`` (None when the profiler saw none)."""
    by_name, counts = kernel_records(fn, reps, (kernel,))
    hits = [k for k in by_name if kernel in k]
    n = sum(counts[k] for k in hits)
    return per_call * sum(by_name[k] for k in hits) / n if n else None


def warm_runs(fn, reps):
    """Wall seconds of ``reps`` more runs of ``fn()`` (warm: kernels
    built, allocator and cuBLAS set up), their median (None when
    ``reps`` is 0), and one more run under torch.profiler: its wall,
    device busy time, idle share and the device activities that took
    longest."""
    import torch
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    wall, busy, by_name, _ = profiled(fn)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"warm_s": walls,
            "warm_median_s": float(np.median(walls)) if walls else None,
            "profiled": {"wall_s": wall, "device_busy_ms": busy,
                         "device_idle_share": None if busy is None
                         else 1.0 - busy / (1e3 * wall),
                         "top_device_ms": {k[:80]: v for k, v in top}}}


def level_grams(pm, min_gram):
    """Recompute a dense PyramidMatch fit Gram from its histograms: each
    level through ``min_gram``, combined with the integer weights
    2^(L-1) c_p as PyramidMatch does.  Returns (K f64 numpy, level
    matrices on the card)."""
    import torch
    cs = pm._level_coeffs()
    scale = float(2 ** max(pm.L - 1, 0))
    acc, mats = None, []
    for j in range(pm.L):
        w = pm.X[0][j].size
        A = torch.from_numpy(pm._level_matrix(pm.X, j, w)).cuda()
        mats.append(A)
        Kj = min_gram(A, A) * float(round(cs[j] * scale))
        acc = Kj if acc is None else acc + Kj
    return (acc.double() / scale).cpu().numpy(), mats


def bound(nbytes, ops, rate):
    """The least time the card could take: the larger of ``nbytes`` over
    the memory rate and ``ops`` over ``rate``, and which of the two."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
    return {"bound_ms": max(t_b, t_o),
            "bound_by": "operations" if t_o >= t_b else "bytes",
            "bytes": int(nbytes), "ops": int(ops)}


def sass_instructions(sass, function):
    """(address, opcode, predicated, branch target or None) of each
    instruction of the first function in ``cuobjdump -sass`` output whose
    name contains ``function``; None when there is none."""
    body = None
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        if function in part.split("\n", 1)[0]:
            body = part
            break
    if body is None:
        return None
    ins = []
    for line in body.splitlines():
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+([^;]*);", line)
        if m:
            text = m.group(2).strip()
            op = re.sub(r"^@!?U?P[T0-9]+\s+", "", text)
            target = re.search(r"0x([0-9a-f]+)", op)
            ins.append((int(m.group(1), 16), op.split()[0] if op else "",
                        text.startswith("@"),
                        int(target.group(1), 16) if target else None))
    return ins


def hot_loops(ins):
    """Each loop of ``ins`` (a backward branch's range) as (start, end,
    its hot path's opcodes: the instructions no forward conditional
    branch inside the loop jumps over)."""
    for addr, op, _, target in ins:
        if not (op.startswith("BRA") and target is not None
                and target < addr):
            continue
        loop = [x for x in ins if target <= x[0] <= addr]
        cold = [(a, t) for a, o, pred, t in loop
                if o.startswith("BRA") and pred and t is not None and t > a]
        yield target, addr, [o for a, o, _, _ in loop
                             if not any(lo < a < hi for lo, hi in cold)]


def sass_inner_loop(sass, function):
    """The FP64 work of the innermost division loop of ``function`` in
    ``cuobjdump -sass`` output: of each loop its hot path (the rare full
    divisions are a cold region); the loop whose hot path holds the most
    ``MUFU.RCP64H`` (one an f64 division, so one a term), with its
    instruction count, its FP64-pipe instructions (DFMA, DADD, DMUL,
    DSETP, DMNMX) and those per term.  None when no such loop is found."""
    ins = sass_instructions(sass, function)
    if ins is None:
        return None
    best = None
    for start, end, hot in hot_loops(ins):
        rcp = sum(o.startswith("MUFU.RCP64H") for o in hot)
        if rcp and (best is None or rcp > best["mufu_rcp64h"]
                    or (rcp == best["mufu_rcp64h"]
                        and len(hot) < best["instructions"])):
            fp64 = sum(o.split(".")[0] in ("DFMA", "DADD", "DMUL", "DSETP",
                                           "DMNMX") for o in hot)
            best = {"loop": [start, end], "instructions": len(hot),
                    "mufu_rcp64h": rcp, "fp64": fp64,
                    "fp64_per_term": fp64 / rcp,
                    "instructions_per_term": len(hot) / rcp}
    return best


# opcodes that leave the INT32 pipe free: memory, control, barriers and
# the uniform datapath
_NOT_INT = ("LD", "ST", "BRA", "EXIT", "BAR", "BSSY", "BSYNC", "WARPSYNC",
            "NOP", "S2R", "S2UR", "CS2R", "DEPBAR", "RET", "CALL", "U")


def k7_loop(sass, s, shared):
    """K7's walk in the built library: the loop of
    ``canonical_codes_kernel<s, shared>`` whose hot path reads the most
    table words (LDS when the table is in shared memory, LDG when read
    through L1, by width), its instructions, those that issue on the
    INT32 pipe's way (memory, control and the uniform datapath left out)
    and those per permutation (one table word a permutation).  Where the
    compiler unrolled the whole walk (s! small) there is no such loop:
    then the whole function, over s! permutations."""
    ins = sass_instructions(sass, "canonical_codes_kernelILi%dELb%dE"
                            % (s, int(shared)))
    if ins is None:
        return None
    load = "LDS" if shared else "LDG"
    best = None
    for start, end, hot in hot_loops(ins):
        words = sum({"64": 2, "128": 4}.get(o.split(".")[-1], 1)
                    for o in hot if o.startswith(load))
        if words and (best is None or words > best["table_words"]):
            alu = sum(not o.startswith(_NOT_INT) for o in hot)
            best = {"loop": [start, end], "instructions": len(hot),
                    "table_words": words, "int_instructions": alu,
                    "int_per_permutation": alu / words}
    if best is None:
        fact = int(np.prod(np.arange(1, s + 1)))
        alu = sum(not o.startswith(_NOT_INT) for _, o, _, _ in ins)
        best = {"loop": None, "instructions": len(ins),
                "table_words": fact, "int_instructions": alu,
                "int_per_permutation": alu / fact}
    return best


def sass_of_library():
    """``cuobjdump -sass`` of the built kernel library and the card's
    maximum SM clock (MHz), or an error string."""
    import shutil
    from grakel_torch import _build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        sass = subprocess.run([tool, "-sass", _build.build()[0]],
                              capture_output=True, text=True,
                              timeout=120).stdout
        mhz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60).stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError) as e:
        return None, None, str(e)
    return sass, mhz, None


def k10_step_chain(sass):
    """K10's Lanczos step in the built route-"warp" kernels
    (``svm_solve_warp<V>``): for each V the smallest loop holding the
    step's square root (MUFU.RSQ), with its instructions, its shuffles
    (SHFL.BFLY: the step's two butterflies, each a chain of dependent
    shuffles) and its other MUFU operations (the reciprocal)."""
    out = {}
    for V in (8, 16, 32, 64):
        ins = sass_instructions(sass, "svm_solve_warpILi%dE" % V)
        best = None
        for addr, op, _, target in ins or ():
            if not (op.startswith("BRA") and target is not None
                    and target < addr):
                continue
            loop = [o for a, o, _, _ in ins if target <= a <= addr]
            if any(o.startswith("MUFU.RSQ") for o in loop) and (
                    best is None or len(loop) < best["instructions"]):
                best = {"loop": [target, addr], "instructions": len(loop),
                        "shfl_bfly": sum(o.startswith("SHFL.BFLY")
                                         for o in loop),
                        "mufu": dict(Counter(o for o in loop
                                             if o.startswith("MUFU")))}
        out[V] = best
    return out


def k9_sass_floor(terms):
    """K9's instruction floor: the FP64 instructions a term takes in the
    built inner loop (``cuobjdump -sass`` of the kernel library), times
    ``terms``, over the card's FP64 issue rate (64 lanes a streaming
    multiprocessor a clock at the maximum SM clock)."""
    import torch
    sass, mhz, err = sass_of_library()
    if err:
        return {"error": err}
    loop = sass_inner_loop(sass, "rw_spectral_gram_kernel")
    if loop is None:
        return {"error": "no division loop found in the SASS"}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rate = sms * 64 * mhz * 1e6
    return dict(loop, sm_clock_mhz=mhz, sms=sms, terms=terms,
                fp64_issue_per_s=rate,
                floor_ms=terms * loop["fp64_per_term"] / rate * 1e3)


def k7_sass_floor(cases):
    """K7's instruction floor for each case (s, graphlets, table in
    shared memory): the INT32-pipe instructions a permutation takes in
    the built walk (``cuobjdump -sass``), times s! permutations a
    graphlet, over the card's INT32 issue rate (64 lanes a streaming
    multiprocessor a clock at the maximum SM clock).  Returns (floors in
    ms, one per case, and the loops read), or (None, error)."""
    import torch
    sass, mhz, err = sass_of_library()
    if err:
        return None, {"error": err}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rate = sms * 64 * mhz * 1e6
    loops, floors = {}, []
    for s, graphlets, shared in cases:
        key = "s%d_%s" % (s, "shared" if shared else "global")
        if key not in loops:
            loops[key] = k7_loop(sass, s, shared)
        lp = loops[key]
        fact = int(np.prod(np.arange(1, s + 1)))
        floors.append(None if lp is None else
                      graphlets * fact * lp["int_per_permutation"]
                      / rate * 1e3)
    return floors, {"loops": loops, "sm_clock_mhz": mhz, "sms": sms,
                    "int32_issue_per_s": rate}


def native_phase(class_path, check, paths, train, held, mutag):
    """The slice of the native host layer: OddSth, NSPD and
    SubgraphMatching through their entry points (paths
    ``oddsth_nci1scale``, ``nspd_nci1scale``, ``sm_mutag``), their
    device Gram stages timed beside their bounds, NSPD's transform
    against the per-level chunk loop it replaced, and the native engines
    held against their Python versions on MUTAG."""
    import torch
    from grakel_torch import GraphKernel, OddSth, SubgraphMatching, native
    from grakel_torch.batch import bucket_size
    from grakel_torch.kernels import nspd as nspd_mod
    from grakel_torch.kernels import odd_sth as odd_mod
    from grakel_torch.ops import gram as gram_ops
    n, nh = len(train), len(held)

    def wall_ms(fn, reps):
        """Host milliseconds of ``fn()`` up to a device sync, mean of
        ``reps`` after one warm call."""
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / reps

    def summary(key):
        p = paths[key]
        print("%s: first %.3f s (fit_transform %.3f, transform %.3f), warm "
              "median %s s, device busy %s ms, idle share %s"
              % (key, p["wall_s"], p["fit_transform_s_first"],
                 p["transform_s"], p["warm_median_s"],
                 p["profiled"]["device_busy_ms"],
                 p["profiled"]["device_idle_share"]), flush=True)

    def pair_products(cols):
        """2 sum over columns of (graphs in the column)^2: the
        multiply-adds a sparse product of these items needs."""
        return 2 * int((np.bincount(cols).astype(np.int64) ** 2).sum())

    # ---------------- OddSth ----------------------------------------- #
    ko = class_path("oddsth_nci1scale", OddSth, train, held, 0, 0,
                    h=None, data="NCI1-scale, fit %d, transform %d"
                    % (n, nh))
    summary("oddsth_nci1scale")
    g, k, f, C = ko._items(ko.X, 0, n)
    gs, ks, fs, fc, single, diag = odd_mod._split(g, k, f, C, n)
    dt = gram_ops.count_dtype(int(diag.max()))
    width = int(ks.max()) + 1
    info = paths["oddsth_nci1scale"]
    info.update(distinct_subtrees=len(C), items=len(g),
                shared_columns=width, shared_items=len(gs),
                count_bound=int(diag.max()), gram_dtype_on_card=str(dt))
    gt_ = torch.from_numpy(gs).cuda()
    fc64, fs64 = fc.astype(np.float64), fs.astype(np.float64)

    def odd_stage():
        # the call OddSth._gram_sym makes, with its arguments
        return gram_ops.coo_counts_gram_rect(
            gt_, ks, fc64, True, gt_, ks, fs64, True, n, n, width, dtype=dt)

    nc, ch = gram_ops.chunk_plan(width)
    Ks = odd_stage().double()
    Ks.diagonal().add_(torch.from_numpy(single).cuda().double())
    kt_ = torch.from_numpy(ks).cuda()
    Fa = torch.sparse_coo_tensor(torch.stack([gt_, kt_]),
                                 torch.from_numpy(fc64).cuda().to(dt),
                                 (n, width)).coalesce()
    Fb = torch.zeros((width, n), dtype=dt, device="cuda")
    Fb[kt_, gt_] = torch.from_numpy(fs64).cuda().to(dt)
    lib = torch.sparse.mm(Fa, Fb)
    check(torch.equal(Ks.diagonal().cpu(), torch.from_numpy(diag).double())
          and torch.equal(lib.double(), odd_stage().double()),
          "oddsth_nci1scale shared-column Gram: diag == host int64 "
          "sum C F^2, == torch.sparse.mm of the same items")
    info["gram_stage"] = dict(
        what="K = F diag(C) F^T over the shared columns: the path's "
             "coo_counts_gram_rect call, %d chunks of %d, %s, TF32 off"
             % (nc, ch, dt),
        ms=cuda_ms(odd_stage, 5), chunks=nc,
        gram_sym_wall_ms=wall_ms(lambda: ko._gram_sym(g, k, f, C, n), 1),
        library_ms=cuda_ms(lambda: torch.sparse.mm(Fa, Fb), 5),
        library="torch.sparse.mm(sparse F C, dense F^T), %s" % dt,
        **bound(int(gs.size * (8 + 8 + 8 + 8) + dt.itemsize * n * n),
                pair_products(ks), FP32_OPS_PER_S))
    del Fb, lib, Ks
    print("oddsth_nci1scale gram stage: %s" % info["gram_stage"],
          flush=True)

    # ---------------- NSPD ------------------------------------------- #
    gk = class_path("nspd_nci1scale", lambda: GraphKernel(
        kernel={"name": "NSPD", "r": 3, "d": 4}), train, held, 0, 0,
        rtol=1e-12, r=3, d=4, data="NCI1-scale, fit %d, transform %d"
        % (n, nh))
    summary("nspd_nci1scale")
    kn = gk.kernel_
    info = paths["nspd_nci1scale"]
    N = kn._X_level_norm_factor
    r, c, w = kn._scaled_items(kn.X, N, n)
    cnt = np.bincount(c)
    hot = cnt[c] > kn._DENSE_COL_MULT
    mid = (cnt[c] >= 2) & ~hot
    info.update(levels=len(kn.X), columns=int(sum(m[3] for m in
                                                  kn.X.values())),
                items=len(c), shared_columns=int((cnt >= 2).sum()),
                hot_columns=int((cnt > kn._DENSE_COL_MULT).sum()),
                pair_products=pair_products(c[mid]) // 2)

    def captured(module, name, call):
        """The arguments of the one call of ``module.name`` that
        ``call()`` makes."""
        real, seen = getattr(module, name), []

        def spy(*a, **kw):
            seen.append((a, kw))
            return real(*a, **kw)
        setattr(module, name, spy)
        try:
            call()
        finally:
            setattr(module, name, real)
        assert len(seen) == 1, (name, len(seen))
        return real, seen[0]

    def fit_gram():
        return gram_ops.sparse_counts_gram(
            r, c, n, weights=w, dense_col_mult=kn._DENSE_COL_MULT,
            dtype=torch.float64, device=torch.device("cuda"))

    hot_fn, (ha, hk) = captured(gram_ops, "_hot_gram", fit_gram)
    info["fit_gram"] = dict(
        what="the path's sparse_counts_gram call (f64, dense block on "
             "the card) and in it the path's _hot_gram call: build D "
             "[%d, %d] f64 on the card, D D^T, fetch" % (n, ha[4]),
        wall_ms=wall_ms(fit_gram, 1),
        hot_gram_wall_ms=wall_ms(lambda: hot_fn(*ha, **hk), 3),
        **bound(int(hot.sum()) * 24 + 8 * n * n,
                pair_products(c[hot]), FP64_OPS_PER_S))

    # the transform's own Gram call, with the arguments it makes it with
    tr_fn, (ta, tk) = captured(nspd_mod, "shared_cols_gram_rect",
                               lambda: kn.transform(held))
    ry, cy, wy, rx, cx, wx = ta[:6]
    S_new = tr_fn(*ta, **tk).cpu().numpy()
    check(np.allclose(S_new, kn.transform(held), rtol=1e-12, atol=0),
          "nspd_nci1scale: the captured shared_cols_gram_rect call == "
          "the path's transform")
    touched = np.unique(cy[np.isin(cy, cx)])
    ny_c = np.bincount(np.searchsorted(touched, cy[np.isin(cy, touched)]))
    nx_c = np.bincount(np.searchsorted(touched, cx[np.isin(cx, touched)]))

    # the route it replaced: a chunked f32 counts-Gram per level at the
    # level's bucketed fit width, each divided by its norms, summed;
    # its items start on the host, as the new call's do
    Y = kn._Y
    per_level = []
    for key, (rows, cols, vals, wd) in Y.items():
        if key not in kn.X:
            continue
        keep = cols < kn.X[key][3]
        xr, xc, xv, xw = kn.X[key]
        ysq = nspd_mod._level_sq_sum((rows, cols, vals, wd), nh)
        per_level.append((rows[keep].astype(np.int64),
                          cols[keep].astype(np.int64), vals[keep],
                          xr.astype(np.int64), xc.astype(np.int64), xv,
                          bucket_size(max(xw, 1)),
                          np.sqrt(np.outer(ysq, N[key]))))

    def chunk_route():
        S = torch.zeros((nh, n), dtype=torch.float64, device="cuda")
        for yr, yc, yv, xr, xc, xv, L, norm in per_level:
            K = gram_ops.coo_counts_gram_rect(
                torch.from_numpy(yr).cuda(), yc, yv, True,
                torch.from_numpy(xr).cuda(), xc, xv, True, nh, n, L)
            S += torch.nan_to_num(K.double() / torch.from_numpy(norm).cuda())
        return S.cpu().numpy()

    old_chunks = sum(gram_ops.chunk_plan(L)[0] for *_, L, _ in per_level)
    check(np.allclose(chunk_route(), S_new, rtol=1e-6, atol=0),
          "nspd_nci1scale: the per-level chunk loop (%d chunks) == the "
          "touched-column product to rtol 1e-6" % old_chunks)
    info["transform_gram"] = dict(
        what="the path's shared_cols_gram_rect call over the %d touched "
             "fit columns of all levels, [%d, %d] x [%d, %d] f64, "
             "fetched" % (len(touched), nh, len(touched), n, len(touched)),
        wall_ms=wall_ms(lambda: tr_fn(*ta, **tk).cpu().numpy(), 5),
        transform_wall_ms=wall_ms(lambda: kn.transform(held), 1),
        replaced_route_wall_ms=wall_ms(chunk_route, 1),
        replaced_route_chunks=old_chunks,
        replaced_route="per level: coo_counts_gram_rect at bucket_size(fit "
                       "width), chunks of 4096, f32, items from the host, "
                       "fetched",
        **bound(24 * (len(ry) + len(rx)) + 8 * nh * n,
                2 * int((ny_c * nx_c).sum()), FP64_OPS_PER_S))
    del per_level
    print("nspd_nci1scale fit Gram %s; transform Gram %s"
          % (info["fit_gram"], info["transform_gram"]), flush=True)

    # ---------------- SubgraphMatching ------------------------------- #
    ksm = class_path("sm_mutag", lambda: SubgraphMatching(k=5), mutag[:40],
                     mutag[40:50], 0, 0, k=5,
                     data="MUTAG via read_data, fit 40, transform 10 (cut: "
                          "a host pair loop, ~2 ms a pair)")
    summary("sm_mutag")

    # ---------------- the native engines against their Python versions #
    t = time.perf_counter()
    fit, tr = mutag[:150], mutag[150:]
    odd_n, odd_p = OddSth(), OddSth()
    odd_p._decompose_native = lambda graphs: None
    a = (odd_n.fit_transform(fit), odd_n.transform(tr))
    b = (odd_p.fit_transform(fit), odd_p.transform(tr))
    check(isinstance(odd_n.X, dict) and isinstance(odd_p.X, tuple)
          and all(np.array_equal(x, y) for x, y in zip(a, b)),
          "MUTAG: OddSth Grams, native decomposition == Python, bit for bit")
    nspd_n = nspd_mod.NeighborhoodSubgraphPairwiseDistance()
    nspd_p = nspd_mod.NeighborhoodSubgraphPairwiseDistance()
    nspd_p._graph_hash_pairs = nspd_p._graph_hash_pairs_py
    a = (nspd_n.fit_transform(fit), nspd_n.transform(tr))
    b = (nspd_p.fit_transform(fit), nspd_p.transform(tr))
    check(all(np.allclose(x, y, rtol=1e-12, atol=1e-14)
              for x, y in zip(a, b)),
          "MUTAG: NSPD Grams, native hashing == Python hashing, rtol 1e-12")
    parsed = ksm.X
    tv_err, pairs = 0.0, 0
    for i in range(0, 40, 4):
        for j in range(i, 40, 7):
            cv, ce = ksm._product_graph(parsed[i], parsed[j])
            tv = np.zeros(ksm.k + 1)
            native._clique_values_py(len(cv), ksm.k, cv, ce, tv)
            got = native.clique_values(cv, ce, ksm.k)
            tv_err = max(tv_err, float(np.max(np.abs(got - tv)
                                              / np.maximum(tv, 1e-300))))
            pairs += 1
    check(tv_err <= 1e-12, "MUTAG: clique_values on %d SM product graphs "
          "== _clique_values_py (largest relative difference %.3g)"
          % (pairs, tv_err))
    strs = [str(sorted(el.items())) + str(sorted(nl.items()))
            for _, nl, el in mutag]
    check(native.ap_hash_batch(strs).tolist()
          == [native._ap_hash_py(x.encode("utf-8")) for x in strs],
          "MUTAG: ap_hash_batch == _ap_hash_py on %d strings" % len(strs))
    paths["sm_mutag"]["native_checks_s"] = time.perf_counter() - t


def spied(module, name, keep=lambda a, kw: (a, kw)):
    """Record ``keep(args, kwargs)`` of every call of ``module.name``, a
    dispatcher in front of a kernel's wrapper (the wrappers count their
    launches under their own names, so they stay in place).  Returns
    (records, restore)."""
    real, seen = getattr(module, name), []

    def spy(*a, **kw):
        seen.append(keep(a, kw))
        return real(*a, **kw)
    setattr(module, name, spy)
    return seen, lambda: setattr(module, name, real)


def slice_gs_rw_phase(class_path, check, paths, train, held, mutag):
    """The slice of the isomorphism layer and the random walks:
    GraphletSampling (``gs_nci1scale``, ``gs_mutag``), RandomWalk
    (``rw_nci1scale``) and RandomWalkLabeled (``rwl_mutag``) through
    their entry points, each against its ``use_device("cpu")`` run, then
    K7, K8 and K9 held against their plain versions at the calls the
    paths made and at the other shapes named in the module docstring.
    Returns the three kernels' rows of the ``kernels`` line."""
    import torch
    from grakel_torch import (GraphletSampling, RandomWalk,
                              RandomWalkLabeled)
    from grakel_torch.kernels import graphlet_sampling as gs_mod
    from grakel_torch.kernels.base import normalize_input
    from grakel_torch.ops import canonical as can_ops
    from grakel_torch.ops import random_walk as rw_ops
    n, nh = len(train), len(held)

    # ---------------- the four paths --------------------------------- #
    k7_seen, restore = spied(gs_mod, "canonical_codes")
    try:
        gk = class_path("gs_nci1scale", lambda: GraphletSampling(
            k=5, sampling={"n_samples": 150}, random_state=42), train,
            held, 0, None, k=5, n_samples=150, random_state=42,
            data="NCI1-scale, fit %d, transform %d" % (n, nh))
    finally:
        restore()
    gs_calls = [(torch.from_numpy(can_ops.adjacency_masks(a[0])).cuda(),
                 a[0][0].shape[0]) for a, _ in k7_seen[
                     :paths["gs_nci1scale"]["launches"]["canonical"]]]
    sizes = sorted(s for _, s in gs_calls[:3])
    check(sizes == [3, 4, 5] and len(gs_calls) == 6,
          "gs_nci1scale launched K7 once a graphlet size in fit_transform "
          "and in transform (sizes %s, %d launches)"
          % (sizes, len(gs_calls)))
    paths["gs_nci1scale"].update(
        bins=len(gk._graph_bins),
        graphlets_fit={s: int(m.shape[0]) for m, s in gs_calls[:3]})
    class_path("gs_mutag", lambda: GraphletSampling(k=5), mutag[:150],
               mutag[150:], 0, 1, k=5, sampling="exhaustive (native ESU)",
               data="MUTAG via read_data, fit 150, transform 38")
    check(paths["gs_mutag"]["launches"]["canonical"] > 0,
          "gs_mutag launched K7 (%d)"
          % paths["gs_mutag"]["launches"]["canonical"])

    k9_seen, restore = spied(rw_ops, "spectral_gram")
    try:
        rk = class_path("rw_nci1scale", RandomWalk, train, held, 0, 1,
                        rtol=1e-8, lamda=0.1,
                        data="NCI1-scale, fit %d, transform %d" % (n, nh))
    finally:
        restore()
    lp = paths["rw_nci1scale"]["launches"]
    rw_log = rk._spectral_log
    check(lp["rw_spectral"] == len(rw_log) == 3 and lp["rw_cg"] == 0
          and {c["route"] for c in rw_log} == {"tile"},
          "rw_nci1scale launched K9 once a Gram call (%d launches over %d "
          "calls: fit, transform, the transform's diagonal; K8 %d): %s"
          % (lp["rw_spectral"], len(rw_log), lp["rw_cg"], rw_log))
    paths["rw_nci1scale"].update(rho=rw_log[0]["rho"],
                                 tiles=[c["tiles"] for c in rw_log])
    print("rw_nci1scale: rho %.4f, plan tiles per Gram %s"
          % (rw_log[0]["rho"], [c["tiles"] for c in rw_log]), flush=True)
    k9_fit = k9_seen[0][0]   # (rows, cols, plan, lamda) of the fit Gram

    k8_seen, restore = spied(rw_ops, "pair_cg")
    try:
        class_path("rwl_mutag", RandomWalkLabeled, mutag[:150],
                   mutag[150:], 0, 1, rtol=1e-4, lamda=0.1,
                   data="MUTAG via read_data, fit 150, transform 38")
    finally:
        restore()
    lp = paths["rwl_mutag"]["launches"]
    k8_calls = k8_seen[:lp["rw_cg"]]
    pairs = sum(int(a[4].shape[0]) for a, _ in k8_calls)
    buckets = sorted({(int(a[0].shape[1]), int(a[1].shape[1]))
                      for a, _ in k8_calls})
    check(lp["rw_cg"] > 0 and lp["rw_cg_by_route"]["warp"] == lp["rw_cg"],
          "rwl_mutag launched only K8's warp route (%d launches, by route "
          "%s; %d pairs, buckets %s)" % (lp["rw_cg"], lp["rw_cg_by_route"],
                                         pairs, buckets))
    paths["rwl_mutag"].update(pairs=pairs, buckets=buckets)

    # ---------------- K7 ----------------------------------------------- #
    def k7_case(masks, s, what, reps=20, time_plain=True):
        got = can_ops.canonical_codes_cuda(masks, s)
        want = can_ops.canonical_codes_plain(masks, s)
        torch.cuda.synchronize()
        B = int(masks.shape[0])
        fact = int(np.prod(np.arange(1, s + 1)))
        # the function's work, at the INT32 pipe's rate: a permutation's
        # key takes 3 integer operations a column (two shifts, an
        # and-or: a column's bit of every row at once) and 1 for the
        # minimum; the earlier count (3 operations a bit read, s(s-1)/2 bit
        # reads a permutation) beside, at this rate and at the fp32 rate
        ops = B * fact * (3 * (s - 1) + 1)
        bit_ops = 3 * B * fact * s * (s - 1) // 2
        case = dict(what=what, s=s, graphlets=B,
                    differing=int((got.long() != want).sum()),
                    ms=cuda_ms(lambda: can_ops.canonical_codes_cuda(
                        masks, s), reps),
                    plain_ms=cuda_ms(lambda: can_ops.canonical_codes_plain(
                        masks, s), 1, 0) if time_plain else None,
                    **bound(12 * B, ops, INT32_OPS_PER_S),
                    bound_ms_bit_count=bound(12 * B, bit_ops,
                                             INT32_OPS_PER_S)["bound_ms"],
                    bound_ms_fp32_rate=bound(12 * B, bit_ops,
                                             FP32_OPS_PER_S)["bound_ms"])
        if s == 8:   # the table's two placements
            for shared in (True, False):
                def placed(shared=shared):
                    return can_ops.canonical_codes_cuda(masks, s,
                                                        shared=shared)
                other = placed()
                torch.cuda.synchronize()
                case["differing"] += int((other.long() != want).sum())
                case["ms_shared" if shared else "ms_l1"] = cuda_ms(placed,
                                                                   reps)
        check(case["differing"] == 0, "K7 %s (s = %d, %d graphlets) == "
              "plain gather-and-min bit for bit" % (what, s, B))
        return case

    k7 = [k7_case(m, s, "gs_nci1scale fit parse") for m, s in gs_calls[:3]]
    rng = np.random.RandomState(11)
    k7_sizes = []
    for s in range(2, 9):
        A = rng.rand(100_000, s, s) < rng.rand(100_000, 1, 1)
        masks = torch.from_numpy(can_ops.adjacency_masks(list(A))).cuda()
        k7_sizes.append(k7_case(masks, s, "100000 random graphlets", 3,
                                time_plain=False))
    floors, k7_sass = k7_sass_floor(
        [(c["s"], c["graphlets"], c["s"] < 8 or can_ops.K7_S8_SHARED)
         for c in k7 + k7_sizes])
    for c, f in zip(k7 + k7_sizes, floors or [None] * len(k7 + k7_sizes)):
        c["sass_floor_ms"] = f
    print("K7 walk in SASS: %s" % json.dumps(k7_sass), flush=True)
    k7_row = {
        "name": "canonical", "route": "cuda",
        "source": "grakel_torch/csrc/canonical.cu",
        "replaces": "grakel_tpu/ops/canonical.py:50",
        "max_abs_err": max(c["differing"] for c in k7 + k7_sizes),
        **{k: sum(c[k] for c in k7) for k in ("ms", "plain_ms", "bound_ms",
                                              "bound_ms_bit_count",
                                              "bound_ms_fp32_rate")},
        "sass_floor_ms": None if floors is None else sum(
            c["sass_floor_ms"] for c in k7),
        "sass": k7_sass,
        "bound_by": "operations", "library_ms": None,
        "library": "none: no single PyTorch call computes a canonical code",
        "summed_over": "the three K7 calls of the gs_nci1scale fit parse "
                       "(graphlet sizes 3, 4, 5)",
        "s8_table": {k: k7_sizes[-1].get(k) for k in ("ms_shared", "ms_l1")},
        "shapes": k7, "random_sizes": k7_sizes}

    # ---------------- K8 ----------------------------------------------- #
    def k8_ops(n1, n2, steps):
        """Flops of the steps each pair ran: per matvec 2 n1 n2 (n1 + n2)
        (labeled too: a label's masks split X's rows and columns, so
        the common labels' products add up to one) and 12 n1 n2 of
        vector work."""
        n1, n2 = n1.cpu().numpy(), n2.cpu().numpy()
        per = 2 * n1 * n2 * (n1 + n2) + 12 * n1 * n2
        return int((per * steps.cpu().numpy()).sum())

    def k8_case(args, what, reps=3, diverges=False):
        """K8 on the arguments of one ``ops.random_walk.pair_cg`` call
        (graph tables, pairs of table rows), held at rtol 1e-4 on every
        pair.  Where lamda mu nu passes 1 (``diverges``), f32 CG may
        amplify rounding without limit on a pair, and only the pairs
        whose plain CG froze and lies within 1e-5 relative of its f64
        evaluation are held; the others are counted, with K8's distance
        from the plain version on them."""
        i32 = lambda t: None if t is None else t.to(torch.int32).contiguous()
        Gx, Gy = args[0].contiguous(), args[1].contiguous()
        nx, ny, ia, ib = (i32(t) for t in args[2:6])
        lamda, Lx, Ly, n_labels = args[6], i32(args[7]), i32(args[8]), \
            args[9]
        route = rw_ops.cg_route(Gx.shape[1], Gy.shape[1], Lx is not None)
        run = lambda: rw_ops.pair_cg_cuda(Gx, Gy, nx, ny, ia, ib, lamda, Lx,
                                          Ly)
        got = run()
        plain = lambda G1, G2, steps=False: rw_ops.pair_cg_plain(
            G1, G2, nx, ny, ia, ib, lamda, Lx, Ly, n_labels,
            return_steps=steps)
        want, steps = plain(Gx, Gy, True)
        held = torch.ones_like(want, dtype=torch.bool)
        if diverges:
            exact = plain(Gx.double(), Gy.double())
            held = (steps < rw_ops.CG_ITERS) & (
                (want.double() - exact).abs() <= 1e-5 * exact.abs())
        rel_all = ((got - want).abs() / want.abs().clamp_min(1e-6)).nan_to_num(
            float("inf"))
        d = (got - want).abs()[held]
        B = int(ia.shape[0])
        nbytes = 4 * (Gx.numel() + Gy.numel() + nx.numel() + ny.numel()
                      + 3 * B) + (0 if Lx is None else
                                  4 * (Lx.numel() + Ly.numel()))
        case = dict(what=what, pairs=B, graphs=(int(Gx.shape[0]),
                                                int(Gy.shape[0])),
                    V1=int(Gx.shape[1]), V2=int(Gy.shape[1]),
                    labeled=Lx is not None, route=route, lamda=lamda,
                    max_abs_err=float(d.max()) if len(d) else 0.0,
                    max_rel_err=float(rel_all[held].max()) if len(d) else 0.0,
                    held_pairs=int(held.sum()),
                    unfrozen_pairs=int((steps == rw_ops.CG_ITERS).sum()),
                    unheld_rel_median=(float(rel_all[~held].median())
                                       if (~held).any() else None),
                    mean_steps=float(steps.float().mean()),
                    ms=cuda_ms(run, reps),
                    plain_ms=cuda_ms(lambda: plain(Gx, Gy), 1, 0),
                    **bound(nbytes, k8_ops(nx.long()[ia.long()],
                                           ny.long()[ib.long()], steps),
                            FP32_OPS_PER_S))
        check(torch.allclose(got[held], want[held], rtol=1e-4, atol=1e-4),
              "K8 %s (%d pairs, buckets %d x %d, %s route) == plain CG to "
              "rtol 1e-4 on %d pairs (largest relative difference %.3g)"
              % (what, B, Gx.shape[1], Gy.shape[1], route,
                 case["held_pairs"], case["max_rel_err"]))
        return case

    k8 = [k8_case(a, "rwl_mutag call %d" % i)
          for i, (a, _) in enumerate(k8_calls)]

    def captured_k8(kernel, graphs):
        seen, restore = spied(rw_ops, "pair_cg")
        try:
            kernel.fit_transform(graphs)
        finally:
            restore()
        return seen

    rng = np.random.RandomState(5)
    one_way = []
    for g in normalize_input(train[:120]):
        U = np.triu(g.get_adjacency_matrix(), 1)
        flip = rng.rand(*U.shape) < 0.5
        one_way.append([np.where(flip, U, 0) + np.where(flip, 0, U).T,
                        {i: 0 for i in range(g.n)}])
    k8_other = [k8_case(a, "directed NCI1-scale pairs (RandomWalk("
                        "lamda=%s) fit, 120 graphs)" % lam, 1,
                        diverges=lam == 0.1)
                for lam in (0.01, 0.1)
                for a, _ in captured_k8(RandomWalk(lamda=lam), one_way)]
    k8_other += [k8_case(a, "labeled NCI1-scale pairs "
                         "(RandomWalkLabeled() fit, 120 graphs)", 1)
                 for a, _ in captured_k8(RandomWalkLabeled(), train[:120])]
    check(any(c["V1"] == c["V2"] == 64 and c["labeled"]
              and c["route"] == "shared" for c in k8_other)
          and any(c["route"] == "warp" and c["labeled"] for c in k8_other)
          and any(c["route"] == "warp" and not c["labeled"]
                  for c in k8_other),
          "K8 held at V = 64, labeled, on the shared route, and on the warp "
          "route labeled and directed")
    div = [c for c in k8_other if c["lamda"] == 0.1 and not c["labeled"]]
    check(sum(c["held_pairs"] for c in div) > 0,
          "K8 held on pairs whose CG converges at RandomWalk()'s lamda 0.1 "
          "on directed NCI1-scale graphs")
    print("K8 at RandomWalk()'s lamda 0.1 on directed NCI1-scale pairs: "
          "%d of %d pairs held (frozen, f32 plain within 1e-5 of f64), %d "
          "ran every step unfrozen; K8 against the plain version on the "
          "unheld pairs, median relative difference a call %s"
          % (sum(c["held_pairs"] for c in div), sum(c["pairs"] for c in div),
             sum(c["unfrozen_pairs"] for c in div),
             ["%.3g" % c["unheld_rel_median"] for c in div
              if c["unheld_rel_median"] is not None]), flush=True)
    reddit = [g for g in heavy_tailed_graphs(**REDDIT_B, seed=0)
              if 65 <= g[0] <= 256][:24]
    by_degree = []
    for nv, s_, d_ in reddit:
        A = np.zeros((nv, nv))
        A[s_, d_] = 1
        deg = A.sum(1).astype(int)
        by_degree.append([A, {i: int(deg[i]) for i in range(nv)}])
    k8_global = [k8_case(a, "REDDIT-B stand-in pairs of 65-256 "
                         "vertices labeled by degree (RandomWalkLabeled("
                         "lamda=0.01) fit, 24 graphs)", 1)
                 for a, _ in captured_k8(RandomWalkLabeled(lamda=0.01),
                                          by_degree)]
    check(any(c["route"] == "global" for c in k8_global),
          "K8's global route held on buckets past 64 (%s)"
          % sorted({(c["V1"], c["V2"], c["route"]) for c in k8_global}))
    k8_row = {
        "name": "rw_cg", "route": "cuda",
        "source": "grakel_torch/csrc/rw_cg.cu",
        "replaces": "grakel_tpu/kernels/random_walk.py:56,88,95",
        "max_abs_err": max(c["max_abs_err"] for c in
                           k8 + k8_other + k8_global),
        **{k: sum(c[k] for c in k8) for k in ("ms", "plain_ms", "bound_ms")},
        "bound_by": "operations", "library_ms": None,
        "library": "none: no single PyTorch call runs a pair CG",
        "summed_over": "every K8 call of the rwl_mutag path (fit, "
                       "transform, transform diagonal; one a bucket pair "
                       "a Gram)",
        "pairs": sum(c["pairs"] for c in k8),
        "shapes": k8, "directed_and_labeled": k8_other,
        "global_route": k8_global}

    # ---------------- K9 ----------------------------------------------- #
    def abs_scale(rows, cols, plan, lamda):
        """sum_ij |sx2 sy2 / den| of every pair, in input order: what f64
        sums in another order can differ by, relative (256 rows at a
        time)."""
        sx, mx, _ = rw_ops.padded_spectra(rows, 0, len(plan.order_r))
        sy, my, _ = rw_ops.padded_spectra(cols, 0, len(plan.order_c))
        lm, m2, s2 = lamda * mx.double(), my.double(), sy.double()
        out = torch.empty((sx.shape[0], sy.shape[0]), dtype=torch.float64,
                          device=sx.device)
        for r0 in range(0, sx.shape[0], 256):
            acc = torch.zeros_like(out[r0:r0 + 256])
            for i in range(sx.shape[1]):
                den = 1.0 - lm[r0:r0 + 256, i, None, None] * m2[None]
                acc += sx[r0:r0 + 256, i, None].double().abs() * (
                    s2[None] / den).abs().sum(2)
            out[r0:r0 + 256] = acc
        K = torch.empty_like(out)
        r = torch.from_numpy(plan.order_r).to(out.device)
        c = torch.from_numpy(plan.order_c).to(out.device)
        K[r[:, None], c[None, :]] = out
        return K

    rows9, cols9, plan9, lam9 = k9_fit
    got = rw_ops.spectral_gram_cuda(rows9, cols9, plan9, lam9)
    want = rw_ops.spectral_gram_plain(rows9, cols9, plan9, lam9)
    worst = float(((got - want).abs()
                   / abs_scale(rows9, cols9, plan9, lam9)).max())
    check(worst <= 1e-12 and torch.equal(got, got.T),
          "K9 == plain f64 evaluation over the rw_nci1scale fit Gram's %d "
          "plan tiles, one launch: largest difference %.3g of the sum of "
          "|terms| (<= 1e-12, above n1 n2 2^-53 at n <= 64), exactly "
          "symmetric" % (len(plan9.tiles), worst))
    del want
    sizes = (rows9[2][1:] - rows9[2][:-1]).long().cpu().numpy()  # plan order
    t9 = plan9.tiles.astype(np.int64)
    terms_launched = int(((t9[:, 1] - t9[:, 0]) * (t9[:, 3] - t9[:, 2])
                          * sizes[t9[:, 1] - 1] * sizes[t9[:, 3] - 1]).sum())
    terms_needed = int((sizes.sum() ** 2 + (sizes ** 2).sum()) // 2)

    def pr11_terms(n_in):
        """The terms PR 11's tiles computed on these graphs: tiles of 256
        graphs of one bucket pair, buckets in order of first appearance,
        only a bucket's lower tiles against itself skipped."""
        groups = {}
        for i, k in enumerate(n_in):
            groups.setdefault(rw_ops.bucket(k), []).append(int(k))
        total = 0
        for V1, a in groups.items():
            for V2, b in groups.items():
                for r0 in range(0, len(a), 256):
                    for c0 in range(0, len(b), 256):
                        if V1 == V2 and c0 < r0:
                            continue
                        total += sum(a[r0:r0 + 256]) * sum(b[c0:c0 + 256])
        return total
    terms_pr11 = pr11_terms(sizes[np.argsort(plan9.order_r)])
    nb9 = 8 * int(rows9[0].numel()) + 8 * len(sizes) + 8 * len(sizes) ** 2
    run9 = lambda: rw_ops.spectral_gram_cuda(rows9, cols9, plan9, lam9)
    t = time.perf_counter()
    k9_row = {
        "name": "rw_spectral", "route": "cuda",
        "source": "grakel_torch/csrc/rw_spectral.cu",
        "replaces": "grakel_tpu/kernels/random_walk.py:134",
        "max_abs_err": worst,
        "max_abs_err_is": "largest |kernel - plain| over the sum of |terms| "
                          "of its entry",
        "ms": cuda_ms(run9, 3),
        "device_ms": device_ms(run9, 3, "rw_spectral_gram"),
        "plain_ms": cuda_ms(lambda: rw_ops.spectral_gram_plain(
            rows9, cols9, plan9, lam9), 1, 0),
        **bound(nb9, 4 * terms_needed, FP64_VECTOR_OPS_PER_S),
        "bound_ms_pr11_count": bound(nb9, 4 * terms_pr11,
                                     FP64_VECTOR_OPS_PER_S)["bound_ms"],
        "terms_needed": terms_needed, "terms_launched": terms_launched,
        "terms_pr11": terms_pr11,
        "library_ms": None,
        "library": "none: no single PyTorch call computes the closed form",
        "summed_over": "the one K9 launch of the rw_nci1scale fit Gram "
                       "(%d plan tiles of up to 32 x 32 graphs; ms: the "
                       "wrapper's call, device_ms: the kernel's record)"
                       % len(plan9.tiles),
        "tiles": len(plan9.tiles)}
    k9_row["sass"] = k9_sass_floor(terms_launched)
    k9_row["timing_s"] = time.perf_counter() - t
    for row in (k7_row, k8_row, k9_row):
        print("%s: %.4f ms, bound %.4f ms by %s, plain %.4f ms, library %s"
              % (row["name"], row["ms"], row["bound_ms"], row["bound_by"],
                 row["plain_ms"], row["library"]), flush=True)
    sass = k9_row["sass"]
    print("rw_spectral: one launch, %d tiles; kernel record %s ms; terms "
          "needed %d, launched %d, PR 11's tiles %d; bound %.4f ms over the "
          "distinct pairs, %.4f ms by PR 11's count; SASS floor %s ms (%s "
          "FP64 instructions a term in the inner loop)"
          % (k9_row["tiles"], k9_row["device_ms"], terms_needed,
             terms_launched, terms_pr11, k9_row["bound_ms"],
             k9_row["bound_ms_pr11_count"], sass.get("floor_ms"),
             sass.get("fp64_per_term")), flush=True)
    return [k7_row, k8_row, k9_row]


def slice_theta_phase(class_path, check, paths, train, held, cun):
    """The slice of the theta kernels, GraphHopper and MultiscaleLaplacian:
    ``SvmTheta(random_state=42)`` (``svmtheta_nci1scale``) and
    ``LovaszTheta(random_state=42)`` (``lovasz_nci1scale``) on the
    NCI1-scale set, ``GraphHopper()`` (``gh_cuneiform``) and
    ``MultiscaleLaplacian(random_state=42)`` (``ml_cuneiform``) on
    Cuneiform, fit 200, transform 67, each against its
    ``use_device("cpu")`` run; then K10 and K11 held against their plain
    versions on the svmtheta path's buckets, K12 on the lovasz path's DR
    steps and K13 on its subsets, each on both of its routes.  Returns
    the four kernels' rows of the ``kernels`` line."""
    import torch
    from grakel_torch import (GraphHopper, LovaszTheta, MultiscaleLaplacian,
                              SvmTheta)
    from grakel_torch.kernels import lovasz_theta as lt_mod
    from grakel_torch.ops import lovasz_sdp, svm_qp
    n, nh = len(train), len(held)

    # ---------------- the four paths --------------------------------- #
    # one_class_solve takes each size bucket's bit rows, start vectors and
    # the rest of its inputs, one launch of K10 and K11 on the card; no
    # dense K is built on the card (no f32 torch.zeros in ops.svm_qp, no
    # dense_from_bits or plain Lanczos on a CUDA tensor) and
    # torch.linalg.eigvalsh does not run there
    solve_seen, r_solve = spied(svm_qp, "one_class_solve",
                                lambda a, kw: a[:5])
    on_card = lambda a, kw: a[0].device.type
    eigvalsh_seen, r_ev = spied(torch.linalg, "eigvalsh", on_card)
    dense_seen, r_dense = spied(svm_qp, "dense_from_bits", on_card)
    plain10_seen, r_p10 = spied(svm_qp, "lanczos_plain", on_card)
    zeros_seen, svm_torch = [], svm_qp.torch

    class ZerosSpy:
        """ops.svm_qp's torch, recording what each torch.zeros makes."""

        def __getattr__(self, name):
            return getattr(svm_torch, name)

        def zeros(self, *a, **kw):
            t = svm_torch.zeros(*a, **kw)
            zeros_seen.append((t.dtype, t.device.type))
            return t
    svm_qp.torch = ZerosSpy()
    try:
        class_path("svmtheta_nci1scale", lambda: SvmTheta(random_state=42),
                   train, held, 0, 0, rtol=2e-2,
                   compare_on=(train[:512], held[:16]), random_state=42,
                   data="NCI1-scale, fit %d, transform %d; held against "
                        "the CPU on the first 512 and 16 (cut: the CPU's "
                        "f32 solve takes ~15 s at full size)" % (n, nh))
    finally:
        for restore in (r_solve, r_ev, r_dense, r_p10):
            restore()
        svm_qp.torch = svm_torch
    lp = paths["svmtheta_nci1scale"]["launches"]
    calls = solve_seen[:lp["svm_solve"]]
    # the fit parse's calls cover its n graphs in increasing V, the
    # transform's its nh
    sizes = np.cumsum([int(c[0].shape[0]) for c in calls])
    fit_b = int(np.searchsorted(sizes, n)) + 1
    vs = [int(c[0].shape[1]) for c in calls]
    check(lp["svm_solve"] > 0 and len(calls) == lp["svm_solve"]
          and lp["svm_lanczos"] == lp["svm_fista"] == lp["svm_solve"]
          and all(c[0].device.type == "cuda" for c in calls)
          and lp["lovasz_dr_step"] == lp["lovasz_min_cone"] == 0
          and sizes[fit_b - 1] == n and sizes[-1] == n + nh
          and all(vs[i] < vs[i + 1] for i in range(fit_b - 1))
          and all(vs[i] < vs[i + 1] for i in range(fit_b, len(vs) - 1)),
          "svmtheta_nci1scale launched K10 and K11 together once a size "
          "bucket a parse (%d launches: buckets %s in fit, %s in "
          "transform; K10 %d launches, K11 %d, none apart)"
          % (lp["svm_solve"], vs[:fit_b], vs[fit_b:], lp["svm_lanczos"],
             lp["svm_fista"]))
    from grakel_torch import _build
    dense_f32 = sum(z == (torch.float32, "cuda") for z in zeros_seen)
    check(not hasattr(_build.load_library(), "grakel_svm_lanczos")
          and dense_f32 == 0 and "cuda" not in dense_seen
          and "cuda" not in plain10_seen,
          "svmtheta_nci1scale built no dense K on the card (f32 torch.zeros "
          "of ops.svm_qp on the card: %d of %d; dense_from_bits on the card "
          "%d, lanczos_plain %d; the library has no dense K10 entry)"
          % (dense_f32, len(zeros_seen), dense_seen.count("cuda"),
             plain10_seen.count("cuda")))
    check("cuda" not in eigvalsh_seen,
          "svmtheta_nci1scale called torch.linalg.eigvalsh on no CUDA "
          "tensor (%d calls, all on the CPU run)" % len(eigvalsh_seen))
    paths["svmtheta_nci1scale"].update(
        buckets_fit=vs[:fit_b], buckets_transform=vs[fit_b:],
        eigvalsh_calls_on_card=eigvalsh_seen.count("cuda"),
        f32_zeros_on_card=dense_f32)

    # K12: each bucket's DR state at its 150th step of the fit parse;
    # K13: the fit parse's subsets
    # K14: step 149's eigenvectors (the warm start of step 150) and step
    # 300's (their orthogonality after the loop's rotations)
    k12_state, k12_count, k14_prev, k14_last = {}, {}, {}, {}

    def keep12(a, kw):
        V = int(a[0].shape[-1])
        k12_count[V] = k12_count.get(V, 0) + 1
        if k12_count[V] == 149 and V not in k14_prev:
            k14_prev[V] = a[5].clone()
        if k12_count[V] == 150 and V not in k12_state:
            k12_state[V] = tuple(x.clone() for x in a[:6])
        if k12_count[V] == 300 and V not in k14_last:
            k14_last[V] = a[5].clone()
    _, r12 = spied(lovasz_sdp, "dr_step", keep12)
    k13_seen, r13 = spied(lt_mod, "min_cone", lambda a, kw: a[0])
    fit_c, tr_c = train[:64], held[:8]
    routes_before = (dict(lovasz_sdp.dr_step_cuda.route_launches),
                     dict(lovasz_sdp.min_cone_cuda.route_launches))
    try:
        class_path("lovasz_nci1scale", lambda: LovaszTheta(random_state=42),
                   train, held, 0, None, rtol=2e-2,
                   compare_on=(fit_c, tr_c),
                   random_state=42,
                   data="NCI1-scale, fit %d, transform %d; held against "
                        "the CPU on the first %d and %d (cut: the CPU's "
                        "SDP and cone loop take minutes at full size)"
                   % (n, nh, len(fit_c), len(tr_c)))
    finally:
        r12()
        r13()
    lp = paths["lovasz_nci1scale"]["launches"]
    buckets = lp["lovasz_dr_step"] // 300
    check(lp["lovasz_dr_step"] > 0 and lp["lovasz_dr_step"] % 300 == 0
          and lp["lovasz_jacobi_eigh"] == 301 * buckets
          and lp["lovasz_min_cone"] == 2 and lp["svm_fista"] == 0,
          "lovasz_nci1scale launched K12 300 times a size bucket (%d), K14 "
          "301 (%d: each step's and theta's eigh) and K13 once a parse (%d)"
          % (lp["lovasz_dr_step"], lp["lovasz_jacobi_eigh"],
             lp["lovasz_min_cone"]))
    k13_fit = k13_seen[0]
    by_route = [{r: c.route_launches[r] - before[r] for r in before}
                for c, before in zip((lovasz_sdp.dr_step_cuda,
                                      lovasz_sdp.min_cone_cuda),
                                     routes_before)]
    check(by_route[0]["global"] == 0 and by_route[0]["tile"] > 0
          and by_route[1] == {"register": by_route[1]["register"],
                              "shared": 0, "global": 0},
          "lovasz_nci1scale's K12 launches took route tile and its K13 "
          "launches route register: %s" % by_route)
    paths["lovasz_nci1scale"].update(
        subsets_fit=int(k13_fit.shape[0]), d=int(k13_fit.shape[1]),
        dr_buckets=sorted(k12_state))

    class_path("gh_cuneiform", GraphHopper, cun[:200], cun[200:], 0, 1,
               rtol=1e-10, kernel_type="linear",
               data="Cuneiform via read_data (real attributes), fit 200, "
                    "transform %d; the Gram one f64 GEMM on the card"
                    % (len(cun) - 200))
    class_path("ml_cuneiform", lambda: MultiscaleLaplacian(random_state=42),
               cun[:200], cun[200:], 0, None, random_state=42,
               compare_on=(cun[:30], cun[200:210]),
               data="Cuneiform via read_data, fit 200, transform %d (host "
                    "numpy: no device program); held against the CPU on "
                    "fit 30, transform 10 (cut: ~11 s a run at full size)"
                    % (len(cun) - 200))
    for key in ("gh_cuneiform", "ml_cuneiform"):
        lp = paths[key]["launches"]
        check(all(lp[k] == 0 for k in ("svm_lanczos", "svm_fista",
                                       "lovasz_dr_step", "lovasz_min_cone",
                                       "lovasz_jacobi_eigh")),
              "%s launched none of K10-K14" % key)

    # ---------------- K10 and K11 ---------------------------------------- #
    def err_shift(a, b):
        return max(float((x - y).abs().max()) for x, y in
                   zip(svm_qp.spectral_shift(*a), svm_qp.spectral_shift(*b)))

    def k10_case(Kb, v0, what, route=None, reps=3):
        """K10 alone (the launch with Lanczos on and iters = 0) on one
        bucket's bit rows and start vectors against its plain version,
        ``lanczos_bits_plain``.  Returns the case and the kernel's
        coefficients."""
        S, V = int(Kb.shape[0]), int(Kb.shape[1])
        run = lambda: svm_qp.lanczos_cuda(Kb, v0, route=route)
        got = run()
        plain = lambda: svm_qp.lanczos_bits_plain(Kb, v0)
        want = plain()
        m = int(got[0].shape[1])
        nnz = int(np.unpackbits(Kb.cpu().numpy().view(np.uint8)).sum())
        # a step: K v as K's nnz adds (K is 0/1: the kernel adds the set
        # entries of its bit rows) and 10 V of vector work, the bit rows
        # read once; beside it the earlier count, the dense GEMV's 2 V^2
        # a step on a dense f32 K
        ops = m * (nnz + 10 * V * S)
        ops_dense = S * m * (2 * V * V + 10 * V)
        ms = cuda_ms(run, reps)
        return dict(what=what, S=S, V=V,
                    route=route or svm_qp.solve_route(V),
                    max_abs_err=err_shift(got, want),
                    max_abs_err_is="largest difference of (scale, dadd, L), "
                                   "the Ritz extremes' use",
                    alpha3_close=bool(torch.allclose(
                        got[0][:, :3], want[0][:, :3], rtol=1e-4,
                        atol=1e-4)),
                    alpha3_max_abs_diff=float(
                        (got[0][:, :3] - want[0][:, :3]).abs().max()),
                    ms=ms, step_us=ms * 1e3 / m,
                    plain_ms=cuda_ms(plain, 1, 0),
                    bound_ms_dense=bound(
                        4 * (S * V * V + S * V + 2 * S * m), ops_dense,
                        FP32_OPS_PER_S)["bound_ms"],
                    nnz=nnz, **bound(4 * (Kb.numel() + S * V + 2 * S * m),
                                     ops, FP32_OPS_PER_S)), got

    def k11_case(args, what, route=None, reps=3):
        """K11 alone (the launch with Lanczos off) on one bucket's inputs
        (Kb, a0, u, s, al, be) against its plain version, spectral_shift +
        fista_plain on the dense K.  Returns the case and the kernel's
        (a, lam)."""
        Kb, _, u, s_t, al, be = args
        S, V, m = int(Kb.shape[0]), int(Kb.shape[1]), int(al.shape[1])
        run = lambda: svm_qp.fista_cuda(*args, route=route)
        got, lam = svm_qp.fista_cuda(*args, route=route)
        K = svm_qp.dense_from_bits(Kb, V)
        scale, dadd, L = svm_qp.spectral_shift(al, be)
        plain = lambda: svm_qp.fista_plain(
            K, args[1], u, s_t, *svm_qp.spectral_shift(al, be))
        want = plain()
        lmin, lmax = svm_qp.tridiagonal_extremes(al, be)
        dmin, dmax = (x.to(al.device).float() for x in
                      svm_qp.tridiagonal_extremes(al.double().cpu(),
                                                  be.double().cpu()))
        same_shift = svm_qp.fista_plain(
            K, args[1], u, s_t,
            *svm_qp.shift_from_extremes(lam[:, 0], lam[:, 1]))

        def kx(a):
            return scale[:, None] * torch.bmm(K, a[:, :, None])[:, :, 0] \
                + dadd[:, None] * a
        unique = max(float((kx(got) - kx(want)).abs().max()),
                     float(((got * kx(got)).sum(1)
                            - (want * kx(want)).sum(1)).abs().max()))
        feasible = max(float((got.sum(1) - s_t).abs().max()),
                       float((-got).clamp_min(0).max()),
                       float((got - u).clamp_min(0).max()))
        big = float(torch.maximum(dmin.abs(), dmax.abs()).max().clamp_min(1))
        T = torch.diag_embed(al) + torch.diag_embed(be[:, :m - 1], 1) \
            + torch.diag_embed(be[:, :m - 1], -1)
        nnz = int(K.sum())
        # an iteration: K y as K's nnz adds (K is 0/1: the kernel adds the
        # set entries of its bit rows), the step (6 V), min/max (2 V), 30
        # bisection steps (4 V each) and the update (5 V); beside it PR
        # 14's count, the dense GEMV's 2 V^2
        ops_dense = S * 300 * (2 * V * V + 133 * V)
        ops = 300 * (nnz + 133 * S * V)
        nbytes = 4 * (Kb.numel() + 3 * S * V + S + 2 * S * m + 2 * S)
        return dict(what=what, S=S, V=V,
                    route=route or svm_qp.solve_route(V),
                    max_abs_err=unique,
                    max_abs_err_is="largest difference of K a and of the "
                                   "objective a^T K a (unique at the "
                                   "optimum of a convex QP)",
                    extremes_err=max(float((lam[:, 0] - dmin).abs().max()),
                                     float((lam[:, 1] - dmax).abs().max()))
                    / big,
                    extremes_err_plain=max(
                        float((lam[:, 0] - lmin).abs().max()),
                        float((lam[:, 1] - lmax).abs().max())) / big,
                    extremes_err_is="largest difference of lambda_min and "
                                    "lambda_max from f64 eigvalsh's (_plain: "
                                    "from the plain version's f32 "
                                    "eigvalsh's), over the largest "
                                    "|eigenvalue| (at least 1)",
                    shift_differs=int(sum(int((x != y).sum()) for x, y in zip(
                        svm_qp.shift_from_extremes(lam[:, 0], lam[:, 1]),
                        (scale, dadd, L)))),
                    alpha_max_abs_diff=float((got - want).abs().max()),
                    alpha_diff_same_shift=float((got - same_shift).abs()
                                                .max()),
                    infeasibility=feasible,
                    ms=cuda_ms(run, reps),
                    plain_ms=cuda_ms(plain, 1, 0),
                    shift_library_ms=cuda_ms(
                        lambda: torch.linalg.eigvalsh(T), 1),
                    bound_ms_dense=bound(nbytes, ops_dense,
                                         FP32_OPS_PER_S)["bound_ms"],
                    nnz=nnz, **bound(nbytes, ops, FP32_OPS_PER_S)), (got, lam)

    def fused_case(inp, coeffs, k11_out, what, route=None, reps=3):
        """The path's launch, K10 and K11 together on one bucket (Kb, v0,
        a0, u, s): equal bit for bit to K10 alone and then K11 alone on
        its coefficients (both the same code, a flag apart)."""
        Kb, v0, a0, u, s_t = inp
        run = lambda: svm_qp.solve_cuda(Kb, v0, a0, u, s_t, route=route)
        a, lam, al, be = run()
        same = all(torch.equal(x, y) for x, y in zip(
            (al, be, a, lam), (*coeffs, *k11_out)))
        return dict(what=what, S=int(Kb.shape[0]), V=int(Kb.shape[1]),
                    route=route or svm_qp.solve_route(int(Kb.shape[1])),
                    equal_to_apart=same, ms=cuda_ms(run, reps))

    k10, k11, fused = [], [], []

    def bucket_cases(inp, what, route=None):
        Kb, v0, a0, u, s_t = inp
        c10, coeffs = k10_case(Kb, v0, what, route)
        c11, out11 = k11_case((Kb, a0, u, s_t, *coeffs), what, route)
        k10.append(c10)
        k11.append(c11)
        fused.append(fused_case(inp, coeffs, out11, what, route))

    # each fit bucket as the path launched it (all its slabs' graphs)
    for i in range(fit_b):
        bucket_cases(calls[i], "svmtheta_nci1scale fit bucket V = %d (its "
                     "one launch, %d graphs)" % (vs[i], calls[i][0].shape[0]))
    # route "block" on the path's widest bucket, and a V = 256 bucket of
    # the REDDIT-B stand-in (129-256 vertices: route "block" on its own)
    bucket_cases(calls[fit_b - 1], "the widest fit bucket, route block",
                 "block")
    big = []
    for nv, s_, d_ in heavy_tailed_graphs(**REDDIT_B, seed=0):
        if 129 <= nv <= 256 and len(big) < 32:
            A = np.zeros((nv, nv))
            A[s_, d_] = 1
            big.append(A)
    seen, restore = spied(svm_qp, "one_class_solve", lambda a, kw: a[:5])
    try:
        svm_qp.one_class_alphas(big, device="cuda")
    finally:
        restore()
    bucket_cases(seen[0], "REDDIT-B stand-in, 32 graphs of 129-256 "
                 "vertices")
    check({c["route"] for c in k10} == {"warp", "block"}
          and all(c["max_abs_err"] <= 1e-4 and c["alpha3_close"]
                  for c in k10),
          "K10 alone == plain Lanczos (lanczos_bits_plain) on both routes: "
          "the shift from its coefficients to 1e-4 (largest %.3g), the "
          "first three alphas to 1e-4 (largest %.3g)"
          % (max(c["max_abs_err"] for c in k10),
             max(c["alpha3_max_abs_diff"] for c in k10)))
    check({c["route"] for c in k11} == {"warp", "block"}
          and all(c["max_abs_err"] <= 1e-4 and c["infeasibility"] <= 1e-4
                  and c["extremes_err"] <= 1e-6
                  and c["extremes_err_plain"] <= 1e-4
                  and c["alpha_diff_same_shift"] <= 1e-3 for c in k11),
          "K11 alone == plain shift + FISTA on both routes: K a and the "
          "objective to 1e-4 (largest %.3g), feasible to 1e-4, the "
          "tridiagonal's extremes to 1e-6 of the largest |eigenvalue| of "
          "f64 eigvalsh's (largest %.3g) and to 1e-4 of the plain f32 "
          "eigvalsh's (%.3g; shifts differing in %d values), the alphas to "
          "1e-3 of fista_plain's on the kernel's shift (%.3g; on the plain "
          "shift, along a minimizer set, up to %.3g)"
          % (max(c["max_abs_err"] for c in k11),
             max(c["extremes_err"] for c in k11),
             max(c["extremes_err_plain"] for c in k11),
             sum(c["shift_differs"] for c in k11),
             max(c["alpha_diff_same_shift"] for c in k11),
             max(c["alpha_max_abs_diff"] for c in k11)))
    check(all(c["equal_to_apart"] for c in fused),
          "K10 and K11 in one launch == K10 alone, then K11 alone on its "
          "coefficients, bit for bit, on every case (%d)" % len(fused))
    Kb0, v00, a00, u0, s0 = calls[0]
    al0, be0 = svm_qp.lanczos_cuda(Kb0, v00)
    dev10 = device_ms(lambda: svm_qp.lanczos_cuda(Kb0, v00), 3, "svm_solve")
    dev11 = device_ms(lambda: svm_qp.fista_cuda(Kb0, a00, u0, s0, al0, be0),
                      3, "svm_solve")
    sass, _, sass_err = sass_of_library()
    chain = sass_err or k10_step_chain(sass)
    rows = []
    for name, cases, replaces, dev, call, lib, summed in (
            ("svm_lanczos", k10, "grakel_tpu/ops/svm_qp.py:93", dev10,
             lambda: svm_qp.lanczos_cuda(Kb0, v00),
             "none: no single PyTorch call runs the loop",
             "K10 alone (the launch with Lanczos on and iters = 0) on the "
             "%d fit buckets of svmtheta_nci1scale, every graph of each; "
             "the path runs it inside its one launch a bucket" % fit_b),
            ("svm_fista", k11, "grakel_tpu/ops/svm_qp.py:114", dev11,
             lambda: svm_qp.fista_cuda(Kb0, a00, u0, s0, al0, be0),
             "none: no PyTorch call runs the FISTA loop (the shift's part "
             "alone, torch.linalg.eigvalsh on the buckets' [S, 64, 64] "
             "tridiagonals, is shift_library_ms)",
             "K11 alone (the launch with Lanczos off) on the %d fit buckets "
             "of svmtheta_nci1scale, every graph of each; the path runs it "
             "inside its one launch a bucket (fused_ms)" % fit_b)):
        main = cases[:fit_b]
        rows.append({
            "name": name, "route": "cuda",
            "source": "grakel_torch/csrc/svm_qp.cu", "replaces": replaces,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            **{k: sum(c[k] for c in main) for k in ("ms", "plain_ms",
                                                    "bound_ms",
                                                    "bound_ms_dense")},
            "bound_by": max(main, key=lambda c: c["bound_ms"])["bound_by"],
            "library_ms": None, "library": lib,
            "device_ms_call0": dev, "wrapper_ms_call0": host_ms(call, 20),
            "summed_over": summed, "shapes": cases,
            "fused_ms": sum(c["ms"] for c in fused[:fit_b]),
            "fused": fused})
    rows[0]["step_chain"] = chain
    rows[1]["shift_library_ms"] = sum(c["shift_library_ms"]
                                      for c in k11[:fit_b])

    # ---------------- K12 ----------------------------------------------- #
    def k12_case(state, what, U0, route=None, reps=20):
        """K12 on a DR state (its edges packed as bit rows, as the DR loop
        packs them once a solve) against its plain version; beside it the
        step's eigendecomposition as the path runs it (K14 from the step
        before's eigenvectors ``U0``).  Bound: Y, X and Ut read, Y', X'
        and R' written, w, n and the bit rows read; beside it the count
        with the edges as floats."""
        E, nn, Y, X, w, U = state
        B, V = int(E.shape[0]), int(E.shape[-1])
        Eb = lovasz_sdp.edge_bits(E)
        Yk, Xk = Y.clone(), X.clone()
        R = lovasz_sdp.dr_step_cuda(Eb, nn, Yk, Xk, w, U, route=route)
        pY, pX, pR = lovasz_sdp.dr_step_plain(E, nn, Y, X, w, U)
        err = max(float((a - b).abs().max())
                  for a, b in ((Yk, pY), (Xk, pX), (R, pR)))
        Yk, Xk = Y.clone(), X.clone()
        run = lambda: lovasz_sdp.dr_step_cuda(Eb, nn, Yk, Xk, w, U,
                                              route=route)
        Rin = (2 * X - Y).contiguous()
        ops = B * (2 * V ** 3 + 12 * V * V)
        W = (V + 31) // 32
        return dict(what=what, B=B, V=V,
                    route=route or lovasz_sdp.k12_route(V), max_abs_err=err,
                    ms=cuda_ms(run, reps),
                    plain_ms=cuda_ms(lambda: lovasz_sdp.dr_step_plain(
                        E, nn, Y, X, w, U), 3),
                    eigh_ms=cuda_ms(lambda: lovasz_sdp.sym_eigh(Rin, U0), 3),
                    bound_ms_float_edges=bound(
                        4 * B * (7 * V * V + V) + 4 * B, ops,
                        FP32_OPS_PER_S)["bound_ms"],
                    **bound(4 * B * (6 * V * V + V + V * W) + 4 * B, ops,
                            FP32_OPS_PER_S))

    def k14_case(M, what, U0=None, reps=3):
        """K14 on M [B, V, V] (from the identity, or from the basis U0)
        against torch.linalg.eigh (its plain version, and the one library
        call): the sorted eigenvalues and the PSD projections U diag(max(w,
        0)) U^T, which are unique, to 1e-4 of the largest |eigenvalue|;
        U's orthogonality; the sweeps each matrix took."""
        B, V = int(M.shape[0]), int(M.shape[-1])
        sw = torch.zeros(B, dtype=torch.int32, device=M.device)
        w, U = lovasz_sdp.jacobi_eigh_cuda(M, U0, sweeps=sw)
        lw, lU = torch.linalg.eigh(M)
        scale = float(lw.abs().max())

        def psd(w, U):
            return (U * w.clamp_min(0)[:, None, :]) @ U.transpose(-1, -2)
        eye = torch.eye(V, device=M.device)
        err = max(float((w.sort(-1).values - lw).abs().max()),
                  float((psd(w, U) - psd(lw, lU)).abs().max())) / scale
        library = cuda_ms(lambda: torch.linalg.eigh(M), 1)
        sw = sw.cpu().numpy()
        return dict(what=what, B=B, V=V, start="identity" if U0 is None
                    else "basis", max_abs_err=err,
                    max_abs_err_is="largest difference of the sorted "
                                   "eigenvalues and the PSD projections, "
                                   "over the largest |eigenvalue|",
                    orthogonality=float((U.transpose(-1, -2) @ U - eye)
                                        .abs().max()),
                    sweeps_mean=float(sw.mean()), sweeps_max=int(sw.max()),
                    ms=cuda_ms(lambda: lovasz_sdp.jacobi_eigh_cuda(M, U0),
                               reps),
                    plain_ms=library, library_ms=library,
                    **bound(4 * B * (2 * V * V + V), B * 9 * V ** 3,
                            FP32_OPS_PER_S))

    k12 = [k12_case(k12_state[V], "lovasz_nci1scale fit, bucket V = %d, "
                    "DR step 150" % V, k14_prev[V]) for V in sorted(k12_state)]
    k12 += [k12_case(k12_state[V], "the same state, route global",
                     k14_prev[V], route="global")
            for V in sorted(k12_state)[-1:]]
    check(all(c["max_abs_err"] <= 1e-4 for c in k12)
          and {c["route"] for c in k12} == {"tile", "global"},
          "K12 == plain DR step (Y, X, R) to 1e-4 on both routes "
          "(largest %.3g)" % max(c["max_abs_err"] for c in k12))
    main12 = [c for c in k12[:len(k12_state)]]
    E0 = k12_state[sorted(k12_state)[-1]]
    Eb0 = lovasz_sdp.edge_bits(E0[0])
    # each fit bucket's DR solve as the path runs it (300 x (K14 + K12)
    # and theta's K14), on its own
    dr_solve = {}
    for V in sorted(k12_state):
        torch.cuda.synchronize()
        t = time.perf_counter()
        lovasz_sdp._theta(*k12_state[V][:2], 300, 1.0)
        torch.cuda.synchronize()
        dr_solve[V] = time.perf_counter() - t
    k12_row = {
        "name": "lovasz_dr_step", "route": "cuda",
        "source": "grakel_torch/csrc/lovasz.cu",
        "replaces": "grakel_tpu/ops/lovasz_sdp.py:58",
        "max_abs_err": max(c["max_abs_err"] for c in k12),
        **{k: sum(c[k] for c in main12) for k in (
            "ms", "plain_ms", "bound_ms", "bound_ms_float_edges",
            "eigh_ms")},
        "bound_by": max(main12, key=lambda c: c["bound_ms"])["bound_by"],
        "bucket_ms": {c["V"]: c["ms"] for c in main12},
        "bucket_bound_ms": {c["V"]: c["bound_ms"] for c in main12},
        "dr_solve_s": sum(dr_solve.values()),
        "dr_solve_s_by_bucket": dr_solve,
        "path_kernels": ["lovasz_dr_step_tile<%d,%d>" % (
            c["V"], lovasz_sdp.k12_tile(c["V"])[0]) for c in main12],
        "library_ms": None,
        "library": "none: no single PyTorch call takes the step",
        "device_ms_widest": device_ms(lambda: lovasz_sdp.dr_step_cuda(
            Eb0, E0[1], E0[2].clone(), E0[3].clone(), *E0[4:]),
            5, "lovasz_dr_step"),
        "eigh_share": None,
        "summed_over": "one DR iteration of each size bucket of the "
                       "lovasz_nci1scale fit parse (one launch a bucket; "
                       "the path runs 300 a bucket a parse)",
        "shapes": k12}
    k12_row["eigh_share"] = k12_row["eigh_ms"] / (k12_row["eigh_ms"]
                                                  + k12_row["ms"])
    # the DR reflection of step 150 of each fit bucket, from step 149's
    # eigenvectors as the path runs it, and from the identity
    refl = {V: (2 * k12_state[V][3] - k12_state[V][2]).contiguous()
            for V in sorted(k12_state)}
    k14 = [k14_case(refl[V], "lovasz_nci1scale fit, bucket V = %d, the "
                    "reflection of DR step 150, from step 149's "
                    "eigenvectors" % V, U0=k14_prev[V])
           for V in sorted(k12_state)]
    k14_cold = [k14_case(refl[V], "the same, from the identity")
                for V in sorted(k12_state)]
    rng = np.random.RandomState(14)
    for V, B in ((4, 64), (128, 64)):
        M = torch.from_numpy(rng.randn(B, V, V).astype(np.float32)).cuda()
        M = M + M.transpose(-1, -2)
        M[:, :, V // 2:] = 0      # half padded, as a bucket's small graphs
        M[:, V // 2:, :] = 0
        k14_cold.append(k14_case(M, "random symmetric, V = %d, half "
                                 "padding" % V))
        Q = torch.linalg.qr(torch.from_numpy(rng.randn(B, V, V)))[0]
        k14_cold.append(k14_case(M, "the same from a random orthogonal "
                                 "basis", U0=Q.float().cuda().transpose(
                                     -1, -2).contiguous().transpose(-1, -2)))
    def dr_solve_logged(E, nn):
        """One bucket's DR solve (``_theta``) with K14's sweeps logged a
        call: a spy in place of ``sym_eigh``, K14's dispatcher, that hands
        each call to K14 as the dispatcher does at these sizes (V <= 128)
        with a sweep-count tensor.  Returns (seconds, sweeps [301, B]:
        the 300 steps' and theta's, (M, U0, U) of DR step 300)."""
        log, at300 = [], []
        real = lovasz_sdp.sym_eigh

        def logged(M, U0=None):
            sw = torch.zeros(M.shape[0], dtype=torch.int32, device=M.device)
            w, U = lovasz_sdp.jacobi_eigh_cuda(M.contiguous(), U0,
                                               sweeps=sw)
            log.append(sw)
            if len(log) == 300:
                at300.append((M.contiguous(), U0, U))
            return w, U
        lovasz_sdp.sym_eigh = logged
        try:
            torch.cuda.synchronize()
            t = time.perf_counter()
            lovasz_sdp._theta(E, nn, 300, 1.0)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
        finally:
            lovasz_sdp.sym_eigh = real
        return dt, torch.stack(log).cpu().numpy(), at300[0]

    def sweep_stats(S, dr_s):
        """Mean sweeps of the DR steps started from the identity (1, 101,
        201) and of the warm ones by how far they lie from the last cold
        one (2-10 and 11-100 after it), the most, and the histogram."""
        k = np.arange(300) % lovasz_sdp.JACOBI_RESTART
        return {"dr_solve_s": dr_s,
                "sweeps_mean": {name: float(S[:300][sel].mean())
                                for name, sel in (
                                    ("from the identity", k == 0),
                                    ("warm, 2-10 after", (k > 0) & (k < 10)),
                                    ("warm, 11-100 after", k >= 10))},
                "sweeps_max": int(S[:300].max()),
                "histogram": np.bincount(S[:300].ravel()).tolist()}

    # the loop's orthogonality after 300 steps of rotations, and each
    # bucket's DR solve again with its sweeps logged step by step
    orth = {V: float((U.transpose(-1, -2) @ U - torch.eye(
        V, device=U.device)).abs().max()) for V, U in k14_last.items()}
    by_step = {}
    for V in sorted(k12_state):
        E, nn = k12_state[V][:2]
        dr_s, S, _ = dr_solve_logged(E, nn)
        by_step[V] = sweep_stats(S, dr_s)
        print("lovasz_jacobi_eigh: bucket V = %d, DR solve %.3f s, mean "
              "sweeps by step %s, histogram %s" % (
                  V, dr_s, by_step[V]["sweeps_mean"],
                  by_step[V]["histogram"]), flush=True)
    # K14 takes a V = 128 bucket warm too, which the NCI1-scale buckets
    # (V <= 64) never reach: the 300-step DR solve of 64 graphs of the
    # REDDIT-B stand-in with 65-128 vertices, U's orthogonality at step
    # 300 and that step's decomposition from step 299's eigenvectors
    wide = [(nv, s_, d_) for nv, s_, d_ in
            heavy_tailed_graphs(**REDDIT_B, seed=0) if 65 <= nv <= 128][:64]
    E128 = np.zeros((len(wide), 128, 128), np.float32)
    for b, (nv, s_, d_) in enumerate(wide):
        E128[b, s_, d_] = 1
        E128[b, d_, s_] = 1
        np.fill_diagonal(E128[b], 0)
    dr_s, S, (M300, U299, U300) = dr_solve_logged(
        torch.from_numpy(E128).cuda(),
        torch.tensor([g[0] for g in wide], dtype=torch.int32).cuda())
    wide_stats = sweep_stats(S, dr_s)
    eye128 = torch.eye(128, device=U300.device)
    wide_orth = float((U300.transpose(-1, -2) @ U300 - eye128).abs().max())
    # the same solve with every step after the first warm: the drift the
    # restarts bound
    every = lovasz_sdp.JACOBI_RESTART
    lovasz_sdp.JACOBI_RESTART = 1 << 30
    try:
        _, _, (_, _, U300w) = dr_solve_logged(
            torch.from_numpy(E128).cuda(),
            torch.tensor([g[0] for g in wide], dtype=torch.int32).cuda())
    finally:
        lovasz_sdp.JACOBI_RESTART = every
    wide_stats["orthogonality_no_restart"] = float(
        (U300w.transpose(-1, -2) @ U300w - eye128).abs().max())
    k14_cold.append(k14_case(M300, "REDDIT-B stand-in, 64 graphs of 65-128 "
                             "vertices (bucket V = 128), the reflection of "
                             "DR step 300, from step 299's eigenvectors",
                             U0=U299))
    print("lovasz_jacobi_eigh: REDDIT-B stand-in bucket V = 128 (%d graphs), "
          "DR solve %.3f s, mean sweeps by step %s, U off orthogonal by "
          "%.3g at step 300 (%.3g with no restart)"
          % (len(wide), dr_s, wide_stats["sweeps_mean"], wide_orth,
             wide_stats["orthogonality_no_restart"]), flush=True)
    orth["128 (REDDIT-B stand-in)"] = wide_orth
    check(all(c["max_abs_err"] <= 1e-4 and c["orthogonality"] <= 1e-4
              for c in k14 + k14_cold)
          and all(v <= 1e-4 for v in orth.values()),
          "K14 == torch.linalg.eigh from the identity and from a basis: "
          "sorted eigenvalues and PSD projections to 1e-4 of the largest "
          "|eigenvalue| (largest %.3g), U orthogonal to 1e-4 (largest "
          "%.3g; %s at DR step 300)" % (
              max(c["max_abs_err"] for c in k14 + k14_cold),
              max(c["orthogonality"] for c in k14 + k14_cold), orth))
    Mw = refl[sorted(refl)[-1]]
    Uw = k14_prev[sorted(refl)[-1]]
    k14_row = {
        "name": "lovasz_jacobi_eigh", "route": "cuda",
        "source": "grakel_torch/csrc/lovasz.cu",
        "replaces": "grakel_tpu/ops/lovasz_sdp.py:44",
        "max_abs_err": max(c["max_abs_err"] for c in k14 + k14_cold),
        **{k: sum(c[k] for c in k14) for k in (
            "ms", "plain_ms", "library_ms", "bound_ms")},
        "bound_by": max(k14, key=lambda c: c["bound_ms"])["bound_by"],
        "cold_ms": sum(c["ms"] for c in k14_cold[:len(k14)]),
        "sweeps_warm": {c["V"]: (c["sweeps_mean"], c["sweeps_max"])
                        for c in k14},
        "sweeps_cold": {c["V"]: (c["sweeps_mean"], c["sweeps_max"])
                        for c in k14_cold[:len(k14)]},
        "orthogonality_step_300": orth, "sweeps_by_step": by_step,
        "sweeps_by_step_v128": wide_stats,
        "dr_solve_s": sum(v["dr_solve_s"] for v in by_step.values()),
        "library": "torch.linalg.eigh on the same matrices (its plain "
                   "version too)",
        "device_ms_widest": device_ms(
            lambda: lovasz_sdp.jacobi_eigh_cuda(Mw, Uw), 3, "jacobi_eigh"),
        "summed_over": "one eigendecomposition of each size bucket of the "
                       "lovasz_nci1scale fit parse at DR step 150, from "
                       "step 149's eigenvectors as the path runs its "
                       "warm steps (one launch a bucket; the path runs "
                       "301 a bucket a parse: every JACOBI_RESTART-th "
                       "step, the first among them, and theta's from the "
                       "identity)",
        "shapes": k14 + k14_cold}

    # ---------------- K13 ----------------------------------------------- #
    def k13_case(A, want, what, route=None, reps=3):
        """K13 on the subsets A against the plain loop's ``want``."""
        S, d, m = (int(x) for x in A.shape)
        run = lambda: lovasz_sdp.min_cone_cuda(A, route=route)
        got = run()
        route, group, reg_d, smem = lovasz_sdp.k13_plan(d, m, route)
        # a step: d m subtract-multiply-adds, the argmax, d updates
        ops = S * 400 * (3 * d * m + 3 * d) + S * 3 * d * m
        return dict(what=what, S=S, d=d, m=m, route=route, group=group,
                    subsets_a_warp=32 // group, reg_d=reg_d, smem=smem,
                    kernel="lovasz_min_cone<%d,%d>" % (
                        reg_d, route != "global"),
                    max_abs_err=float((got - want).abs().max()),
                    differing=int((got != want).sum()),
                    ms=cuda_ms(run, reps),
                    **bound(4 * S * d * m + 4 * S, ops, FP32_OPS_PER_S))

    t0 = time.perf_counter()
    q_bad, q_seen, q_first = lovasz_sdp.min_cone_quotient_check("cuda")
    q_s = time.perf_counter() - t0
    check(q_bad == 0 and q_seen == 2 * (2 ** 30 + 1) * lovasz_sdp.MEC_ITERS,
          "K13's quotient (reciprocal and two fused corrections) == "
          "__fdiv_rn bit for bit on every f32 in [-2, 2] and every divisor "
          "2 .. %d: %d of %d pairs differ (first %s; %.2f s)"
          % (lovasz_sdp.MEC_ITERS + 1, q_bad, q_seen, q_first, q_s))
    want13 = []
    plain13 = cuda_ms(lambda: want13.append(
        lovasz_sdp.min_cone_plain(k13_fit)), 1, 0)
    want13 = want13[0]
    k13 = [k13_case(k13_fit, want13, "lovasz_nci1scale fit parse, every "
                    "subset")]
    k13[0]["plain_ms"] = plain13
    k13 += [k13_case(k13_fit[:20000], want13[:20000], "the first 20000 of "
                     "them, route %s" % r, route=r)
            for r in ("register", "shared", "global")]
    check(all(c["max_abs_err"] <= 1e-5 for c in k13)
          and {c["route"] for c in k13} == {"register", "shared", "global"},
          "K13 == plain cone loop on every route to 1e-5 (the same far "
          "columns; largest %.3g)" % max(c["max_abs_err"] for c in k13))
    k13_row = {
        "name": "lovasz_min_cone", "route": "cuda",
        "source": "grakel_torch/csrc/lovasz.cu",
        "replaces": "grakel_tpu/kernels/lovasz_theta.py:48",
        "max_abs_err": max(c["max_abs_err"] for c in k13),
        **{k: k13[0][k] for k in ("ms", "plain_ms", "bound_ms",
                                  "bound_by")},
        "device_ms": device_ms(lambda: lovasz_sdp.min_cone_cuda(k13_fit), 2,
                               "lovasz_min_cone"),
        "route_ms_20000": {c["route"]: c["ms"] for c in k13[1:]},
        "quotient_check": {"pairs": q_seen, "differing": q_bad, "s": q_s},
        "path_kernels": [k13[0]["kernel"]],
        "library_ms": None,
        "library": "none: no single PyTorch call runs the iteration",
        "summed_over": "the one K13 launch of the lovasz_nci1scale fit "
                       "parse (%d subsets)" % k13[0]["S"],
        "shapes": k13}
    rows += [k12_row, k13_row, k14_row]
    for row in rows:
        print("%s: %.4f ms, bound %.4f ms by %s, plain %.4f ms"
              % (row["name"], row["ms"], row["bound_ms"], row["bound_by"],
                 row["plain_ms"]), flush=True)
    print("lovasz_dr_step: eigh %.4f ms beside the kernel's %.4f ms an "
          "iteration over the fit buckets (eigh share %.3f)"
          % (k12_row["eigh_ms"], k12_row["ms"], k12_row["eigh_share"]),
          flush=True)
    print("lovasz_dr_step: by bucket %s ms (bounds %s); bound %.4f ms, "
          "%.4f ms with the edges as floats; the fit parse's DR solve %.3f "
          "s (%s)"
          % (k12_row["bucket_ms"], k12_row["bucket_bound_ms"],
             k12_row["bound_ms"], k12_row["bound_ms_float_edges"],
             k12_row["dr_solve_s"], dr_solve), flush=True)
    print("lovasz_min_cone: %.4f ms over the fit parse (%d subsets, d = %d, "
          "m = %d, %d a warp); the first 20000 by route %s ms"
          % (k13_row["ms"], k13[0]["S"], k13[0]["d"], k13[0]["m"],
             k13[0]["subsets_a_warp"], k13_row["route_ms_20000"]),
          flush=True)
    print("lovasz_jacobi_eigh: %.4f ms from step 149's eigenvectors, %.4f "
          "ms from the identity, over the fit buckets at DR step 150; "
          "sweeps (mean, max) %s and %s; the fit parse's DR solve %.3f s"
          % (k14_row["ms"], k14_row["cold_ms"], k14_row["sweeps_warm"],
             k14_row["sweeps_cold"], k14_row["dr_solve_s"]), flush=True)
    print("svm_lanczos: %.4f ms over the %d fit buckets (K10 alone; by "
          "bucket %s ms, a step %s us), bound %.4f ms (K's nnz), %.4f ms "
          "(the dense count); route block on the widest %.4f, V = 256 "
          "%.4f; the step in the built kernel %s"
          % (rows[0]["ms"], fit_b, [c["ms"] for c in k10[:fit_b]],
             [round(c["step_us"], 3) for c in k10[:fit_b]],
             rows[0]["bound_ms"], rows[0]["bound_ms_dense"],
             k10[fit_b]["ms"], k10[-1]["ms"], chain),
          flush=True)
    print("svm_fista: %.4f ms over the %d fit buckets (K11 alone; the "
          "shift's eigvalsh alone %.4f ms), bound %.4f ms (K's nnz), %.4f "
          "ms (the dense product's count); the path's fused launch %.4f ms "
          "over them (by bucket %s)"
          % (rows[1]["ms"], fit_b, rows[1]["shift_library_ms"],
             rows[1]["bound_ms"], rows[1]["bound_ms_dense"],
             rows[1]["fused_ms"], [c["ms"] for c in fused[:fit_b]]),
          flush=True)
    return rows


def csr_of(coo):
    """(node_off, adj_off, adj) of (n, src, dst) COO graphs, each
    vertex's neighbours in edge order: the native BFS engine's input."""
    node_off = np.zeros(len(coo) + 1, np.int64)
    node_off[1:] = np.cumsum([n for n, _, _ in coo])
    deg, adj = np.zeros(int(node_off[-1]) + 1, np.int64), []
    for (n, s, r), lo in zip(coo, node_off):
        deg[lo + 1:lo + n + 1] = np.bincount(s, minlength=n)
        adj.append(np.asarray(r, np.int32)[np.argsort(s, kind="stable")])
    return node_off, np.cumsum(deg), np.concatenate(adj)


def sp_stream_phase(run_path, check, paths):
    """ShortestPath's stream mode (its parse keeps COO edges once the
    dense buckets would pass ``_STREAM_BYTES``), the paths
    ``sp_stream_redditm12k`` (the BFS route at full REDDIT-M-12K scale),
    ``sp_stream_slab`` (the slab route: K3 a slab at a time on the card)
    and ``sp_stream_dd`` (labeled, on the DD stand-in).  Returns the
    slab path's kernel (its fit parse's slabs are K3's inputs on the
    route) and the REDDIT-M-12K stand-in's graphs of the top bucket."""
    import scipy.sparse as sps
    import torch
    from grakel_torch import Graph, GraphKernel, ShortestPath, native
    from grakel_torch import use_device

    def graphs_of(coo, labels=None):
        return [Graph.from_arrays(n, s, r, node_labels=None if labels is None
                                  else dict(enumerate(labels[i].tolist())))
                for i, (n, s, r) in enumerate(coo)]

    def dense_bytes(coo):
        return sum(4 * max(8, -(-n // 8) * 8) ** 2 for n, _, _ in coo)

    def run(make, fit, tr, dev=None):
        """fit_transform of ``fit``, diagonal(), transform of ``tr``, both
        diagonals, on ``dev`` (None: the card)."""
        k = make()
        with use_device(dev):
            t = time.perf_counter()
            K = k.fit_transform(fit)
            t_fit = time.perf_counter() - t
            d = k.diagonal()
            t = time.perf_counter()
            Kt = k.transform(tr)
            t_tr = time.perf_counter() - t
            xd, yd = k.diagonal()
        return {"out": (K, d, Kt, xd, yd), "fit_transform_s": t_fit,
                "transform_s": t_tr, "k": k}

    def path(key, make, fit, tr, warm, **info):
        """Drive ``make()``'s kernel on the card as a path (counts read
        around it, the peak of device memory beside), check its outputs'
        shapes and diagonals, then ``warm`` warm runs and a profiled
        one (none when ``warm`` is None)."""
        torch.cuda.reset_peak_memory_stats()
        r, secs, launches = run_path(key, lambda: run(make, fit, tr))
        K, d, Kt, xd, yd = r["out"]
        k = getattr(r["k"], "kernel_", r["k"])   # GraphKernel's kernel
        check(K.shape == (len(fit), len(fit)) and np.isfinite(K).all()
              and Kt.shape == (len(tr), len(fit)) and np.isfinite(Kt).all()
              and np.array_equal(np.diagonal(K), d)
              and np.array_equal(xd, d),
              "%s Grams finite, shapes %s %s, diag(K) == diagonal()"
              % (key, K.shape, Kt.shape))
        paths[key] = dict(
            info, graphs=len(fit), held_out=len(tr), wall_s=secs,
            fit_transform_s_first=r["fit_transform_s"],
            transform_s=r["transform_s"], launches=launches,
            stream=(k.X["stream"], k._Y["stream"]),
            route=k._stream_plan(k.X)[0] if k.X["stream"] else "dense",
            bfs_s=(k.X.get("bfs_s"), k._Y.get("bfs_s")),
            stages_s=dict(k.timer_.times), gram_dtype=str(K.dtype),
            peak_device_bytes=torch.cuda.max_memory_allocated(),
            max_vertices=int(k.X["max_V"]),
            dense_bucket_bytes=sum(
                4 * len(b[0]) * b[3].shape[1] ** 2 for b in k.X["buckets"]))
        if warm is not None:
            paths[key].update(warm_runs(lambda: run(make, fit, tr), warm))
        print("%s: %s" % (key, {q: paths[key][q] for q in (
            "wall_s", "route", "bfs_s", "stages_s", "peak_device_bytes",
            "dense_bucket_bytes")}), flush=True)
        return r

    # ------------- REDDIT-M-12K scale, the BFS route, not cut ---------- #
    t = time.perf_counter()
    coo = heavy_tailed_graphs(seed=SEED, **REDDIT_M12K)
    coo_held = heavy_tailed_graphs(seed=SEED + 1,
                                   **dict(REDDIT_M12K, n_graphs=N_HELD))
    gen_s = time.perf_counter() - t
    fit, held = graphs_of(coo), graphs_of(coo_held)

    def unlabeled():
        return GraphKernel(kernel={"name": "shortest_path",
                                   "with_labels": False})

    key = "sp_stream_redditm12k"
    r = path(key, unlabeled, fit, held, 0, generate_s=gen_s,
             data="REDDIT-M-12K stand-in (tools/full_bench.py:80-82's "
                  "parameters, seed %d), fit all %d graphs, transform %d "
                  "drawn with seed %d; not cut"
                  % (SEED, len(coo), N_HELD, SEED + 1))
    k = r["k"].kernel_
    p = paths[key]
    check(k.X["stream"] and p["route"] == "bfs"
          and all(isinstance(b[1], list) for b in k.X["buckets"])
          and p["launches"]["floyd_warshall"] == 0,
          "%s: the fit parse in stream mode (no dense bucket built; %.2f "
          "GB of them dense), the BFS route, no K3 launch; the transform "
          "parse %s" % (key, p["dense_bucket_bytes"] / 1e9,
                        "in stream mode" if k._Y["stream"] else "dense"))
    # the same Grams from the engine's count stream, assembled here: the
    # smoke's own CSR, one scipy.sparse count matrix over the keys of
    # both sides, multiplied in f64 on the host
    t = time.perf_counter()
    D = max(n for n, _, _ in coo + coo_held) + 1
    streams = [native.sp_bfs_counts_native(*csr_of(c), np.zeros(
        sum(n for n, _, _ in c), np.int32), 1, D) for c in (coo, coo_held)]
    keys = np.unique(np.concatenate([s[1] for s in streams]))
    Cx, Cy = (sps.csr_matrix((c.astype(np.float64),
                              (g, np.searchsorted(keys, ids))),
                             shape=(len(cc), len(keys))).toarray()
              for (g, ids, c), cc in zip(streams, (coo, coo_held)))
    K, d, Kt, xd, yd = r["out"]
    same = (np.array_equal(K, Cx @ Cx.T) and np.array_equal(Kt, Cy @ Cx.T)
            and np.array_equal(yd, (Cy * Cy).sum(1)))
    p["reference_s"] = time.perf_counter() - t
    p["keys"] = len(keys)
    check(same and K.dtype == np.float64,
          "%s: Grams and Y's diagonal == the f64 product of the count "
          "stream the smoke built itself (%d keys), bit for bit"
          % (key, len(keys)))
    del Cx, Cy, K, Kt, r
    cut = 1000
    card = run(unlabeled, fit[:cut], held)["out"]
    cpu = run(unlabeled, fit[:cut], held, "cpu")["out"]
    p["cpu_cut"] = ("the CPU run on the first %d fit graphs and the %d "
                    "held out" % (cut, N_HELD))
    check(all(np.array_equal(a, b) for a, b in zip(card, cpu)),
          "%s Grams and diagonals == use_device('cpu') ones on the first "
          "%d graphs, bit for bit" % (key, cut))

    coo_m12k = coo
    # ------------- the slab route: K3 a slab at a time ----------------- #
    sub = [g for g in coo[:2000] if g[0] <= 512]
    sub_held = [g for g in coo_held if g[0] <= 512]
    fit_s, held_s = graphs_of(sub), graphs_of(sub_held)

    def slab_kernel():
        k = ShortestPath(with_labels=False)
        k._STREAM_BFS = False
        return k

    key = "sp_stream_slab"
    r = path(key, slab_kernel, fit_s, held_s, 1,
             data="the REDDIT-M-12K stand-in's graphs of at most 512 "
                  "vertices among its first 2000 (fit) and among the %d "
                  "held out" % N_HELD,
             cut="graphs past 512 vertices and past the first 2000 left "
                 "out: the slab route runs K3 on every padded slab")
    k = slab_k = r["k"]
    p = paths[key]
    slabs = [sum(-(-len(b[0]) // k._slab_cap(b[3].shape[1]))
                 for b in q["buckets"]) for q in (k.X, k._Y)]
    p["slabs"] = slabs
    check(k.X["stream"] and p["route"] == "slab"
          and p["launches"]["floyd_warshall"] == sum(slabs),
          "%s launched K3 once a slab: %d launches, %s slabs (fit, "
          "transform), by route %s" % (
              key, p["launches"]["floyd_warshall"], slabs,
              p["launches"]["floyd_warshall_by_route"]))
    out_bfs = run(lambda: ShortestPath(with_labels=False), fit_s, held_s)

    def dense(with_labels):
        """ShortestPath held in dense mode whatever its input's size."""
        k = ShortestPath(with_labels=with_labels)
        k._STREAM_BYTES = 1 << 62
        return k

    out_dense = run(lambda: dense(False), fit_s, held_s)
    check(not out_dense["k"].X["stream"] and all(
        np.array_equal(a, b) and np.array_equal(a, c) for a, b, c in zip(
            r["out"], out_bfs["out"], out_dense["out"])),
        "%s Grams and diagonals == the BFS route's and dense mode's, bit "
        "for bit" % key)
    # ------------- DD stand-in, labeled ------------------------------- #
    coo = heavy_tailed_graphs(seed=SEED, **DD)
    coo_held = heavy_tailed_graphs(seed=SEED + 1,
                                   **dict(DD, n_graphs=N_HELD))
    rng = np.random.RandomState(4321)
    labels = [rng.randint(0, DD_LABELS, n) for n, _, _ in coo + coo_held]
    for lab in labels[len(coo)::4]:
        lab[0] = DD_LABELS          # unseen at fit
    fit, held = graphs_of(coo, labels), graphs_of(coo_held,
                                                  labels[len(coo):])
    key = "sp_stream_dd"
    r = path(key, ShortestPath, fit, held, None,
             data="DD stand-in (tools/full_bench.py:65-67's parameters, "
                  "seed %d; %d node labels from RandomState(4321), label "
                  "%d planted in every fourth held-out graph), fit %d, "
                  "transform %d drawn with seed %d; not cut"
                  % (SEED, DD_LABELS, DD_LABELS, len(coo), N_HELD,
                     SEED + 1))
    k = r["k"]
    p = paths[key]
    L, D = len(k._enum), k.X["max_V"]
    # the fit's stream (the count of keys is the same in every encoding)
    p["keys"] = len(np.unique(next(iter(k.X["bfs_coo"].values()))[1]))
    check(k.X["stream"] and p["route"] == "bfs"
          and p["dense_bucket_bytes"] > k._STREAM_BYTES
          and L * L * D > k._DIRECT_MAX_WIDTH and L == DD_LABELS + 1,
          "%s: stream mode (%.2f GB dense), the BFS route, L^2 D = %d "
          "past the direct width (%d fit keys compacted)"
          % (key, p["dense_bucket_bytes"] / 1e9, L * L * D, p["keys"]))
    out_dense = run(lambda: dense(True), fit, held)
    check(not out_dense["k"].X["stream"] and all(
        np.array_equal(a, b) for a, b in zip(r["out"], out_dense["out"])),
        "%s Grams and diagonals == dense mode's on the card, bit for bit"
        % key)
    p["dense_route"] = out_dense["k"]._plan(out_dense["k"].X)[0]
    top = max(-(-n // 8) * 8 for n, _, _ in coo_m12k)
    return slab_k, [g for g in coo_m12k if -(-g[0] // 8) * 8 == top]


def stream_top_slab(k, top, check):
    """The slab route at the top bucket: one slab of the graphs ``top``
    (the stand-in's largest, (n, src, dst)) through ``k``'s slab loop.
    K3's time on it (CUDA events) and the whole slab step's (the upload,
    the scatter, K3, the ids and the ``index_add_``; host clock to a
    sync), each a graph; the slab's counts held against the BFS
    engine's."""
    import torch
    from grakel_torch import Graph, native, use_device
    from grakel_torch.ops import floyd_warshall as fw_ops
    with use_device(None):
        k._method_calling = 1
        p = k.parse_input([Graph.from_arrays(n, s, r) for n, s, r in top],
                          stream=True)
        A, M, _, _ = next(k._slabs(p))
        n, V = A.shape[:2]

        def step():
            p["counts"] = {}
            return k._slab_counts(p, 1, V)

        ms = cuda_ms(lambda: fw_ops.floyd_warshall_cuda(A, M, True), 2)
        step()
        torch.cuda.synchronize()
        t = time.perf_counter()
        C = step()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t) * 1e3
        C = C[:len(top)].double().cpu().numpy()
    g, ids, c = native.sp_bfs_counts_native(*csr_of(top), np.zeros(
        sum(q for q, _, _ in top), np.int32), 1, V)
    Cb = np.zeros_like(C)
    np.add.at(Cb, (g, ids), c)
    check(np.array_equal(C, Cb), "the slab route's counts at the top bucket "
          "(%d graphs of %d-%d vertices, V = %d, %d in its first slab) == "
          "the BFS engine's" % (len(top), min(q for q, _, _ in top),
                                max(q for q, _, _ in top), V, n))
    # 2 V^3 min-plus operations a graph; adj and mask read, S written once
    ops, nbytes = 2.0 * n * V ** 3, 8.0 * n * V * V + n * V
    return {"graphs": n, "V": V, "route": fw_ops.fw_route(V, True),
            "ms": ms, "ms_per_graph": ms / n,
            **bound(nbytes, ops, FP32_OPS_PER_S),
            "slab_step_ms": step_ms, "slab_step_ms_per_graph": step_ms / n}


ARXIV = dict(n=169_343, edges=1_166_243, labels=40)   # ogbn-arxiv's counts


def arxiv_sized_graph(seed):
    """A graph at ogbn-arxiv's size: 169,343 vertices and 1,166,243
    undirected edges drawn uniformly (no self-loops, no repeats) and 40
    vertex labels, all from ``seed``; both directions of each edge.
    Returns (n, senders, receivers, labels)."""
    rng = np.random.RandomState(seed)
    n, m = ARXIV["n"], ARXIV["edges"]
    pairs = np.zeros(0, np.int64)
    while len(pairs) < m:
        a = rng.randint(0, n, 2 * m).astype(np.int64)
        b = rng.randint(0, n, 2 * m).astype(np.int64)
        keep = a != b
        lo, hi = np.minimum(a, b)[keep], np.maximum(a, b)[keep]
        pairs = np.unique(np.concatenate([pairs, lo * n + hi]))
    pairs = pairs[rng.permutation(len(pairs))[:m]]
    u, v = pairs // n, pairs % n
    return (n, np.concatenate([u, v]).astype(np.int32),
            np.concatenate([v, u]).astype(np.int32),
            rng.randint(0, ARXIV["labels"], n))


def parallel_phase(run_path, check, paths, train, held):
    """The multi-GPU layer on a one-rank NCCL mesh (``make_mesh()``: a
    world of one, no launcher): ``dist_wl_nci1scale``
    (``distributed_wl_gram`` on the 4110 NCI1-scale graphs, then WL's
    transform of the 64 held out under ``use_mesh``) and
    ``large_wl_arxiv`` (``LargeGraphWL(n_iter=5)`` on the NCI1-scale
    set plus one graph at ogbn-arxiv's size: K2 reach 2 on the big
    graph, reach 1 on the rest), each equal to ``WeisfeilerLehman(
    n_iter=5)`` on the card bit for bit; the CPU route (a gloo world of
    one) against the card on a cut.  Then K2 reach 2 alone on the big
    graph's CSR in four row blocks, as four ranks would run it.  Returns
    reach 2's measurements for K2's row."""
    import torch
    from grakel_torch import Graph, WeisfeilerLehman, use_device
    from grakel_torch.kernels.base import normalize_input
    from grakel_torch.ops import wl as wl_ops
    from grakel_torch.ops.gram import use_mesh
    from grakel_torch.parallel import (LargeGraphWL, distributed_wl_gram,
                                       make_mesh)
    from grakel_torch.parallel.mesh import gather_blocks, shutdown

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    t = time.perf_counter()
    mesh = make_mesh()
    make_s = time.perf_counter() - t
    t = time.perf_counter()
    gather_blocks(mesh, torch.zeros(1, device=mesh.device))
    torch.cuda.synchronize()
    first_gather_s = time.perf_counter() - t
    setup = {"make_mesh_s": make_s, "first_all_gather_s": first_gather_s,
             "backend": mesh.backend, "size": mesh.size}
    print("parallel: %s, set-up %s" % (mesh, setup), flush=True)
    check(mesh.backend == "nccl" and mesh.size == 1,
          "make_mesh() with no launcher: a world of one on NCCL (%s)"
          % mesh)

    graphs = normalize_input(train)
    wl_ref = WeisfeilerLehman(n_iter=5)
    K0 = wl_ref.fit_transform(graphs)
    Kt0 = wl_ref.transform(held)

    # ---------------- distributed WL, NCI1-scale, not cut -------------- #
    def dist_run():
        t = time.perf_counter()
        K = distributed_wl_gram(graphs, 5, mesh)
        t_fit = time.perf_counter() - t
        k = WeisfeilerLehman(n_iter=5)
        k.mesh = mesh
        k.fit(graphs)
        t = time.perf_counter()
        with use_mesh(mesh):
            Kt = k.transform(held)
        return K, Kt, t_fit, time.perf_counter() - t

    gathers = gather_blocks.calls
    (K, Kt, t_fit, t_tr), secs, launches = run_path("dist_wl_nci1scale",
                                                    dist_run)
    gathers = gather_blocks.calls - gathers
    check(np.array_equal(K, K0) and K.dtype == K0.dtype,
          "dist_wl_nci1scale Gram == WeisfeilerLehman(n_iter=5) on the "
          "card bit for bit (%s)" % K.dtype)
    check(np.array_equal(Kt, Kt0), "dist_wl_nci1scale: WL's transform of "
          "the held-out graphs under use_mesh == without a mesh")
    check(launches["wl_hash_refine"] == 10 and gathers == 6,
          "dist_wl_nci1scale launched K2 reach 1 once a generation in the "
          "distributed fit and in the transform (%d) and all-gathered the "
          "keys a generation and the Gram once (%d)"
          % (launches["wl_hash_refine"], gathers))
    paths["dist_wl_nci1scale"] = {
        "graphs": len(graphs), "held_out": len(held), "n_iter": 5,
        "wall_s": secs, "fit_transform_s_first": t_fit,
        "transform_s": t_tr, "launches": launches, "all_gathers": gathers,
        "mesh": repr(mesh), "group_setup": setup,
        "gram_dtype": str(K.dtype)}
    paths["dist_wl_nci1scale"].update(warm_runs(
        lambda: distributed_wl_gram(graphs, 5, mesh), 3))
    # like for like: WL-VH's path parses the raw lists each run, this
    # one is handed parsed graphs; WL on the same parsed graphs, warm
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        WeisfeilerLehman(n_iter=5).fit_transform(graphs)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    paths["dist_wl_nci1scale"]["wl_same_input_warm_s"] = walls
    # the host's stages of the distributed fit, each timed alone (warm),
    # and the rest (generations: ring, K2, gathers, compaction; the
    # Gram's gather and fetch) as the warm median less them
    from grakel_torch.parallel import wl as pwl
    st = {}
    t = time.perf_counter()
    enum = pwl.shared_label_enum(graphs)
    st["label_enum"] = time.perf_counter() - t
    t = time.perf_counter()
    _, _, gpd, n_pad = pwl.shard_graphs(graphs, mesh, enum)
    torch.cuda.synchronize()
    st["rank_batch"] = time.perf_counter() - t
    t = time.perf_counter()
    pwl.block_layout(graphs, mesh.size, gpd, n_pad, mesh.device)
    torch.cuda.synchronize()
    st["block_layout"] = time.perf_counter() - t
    st["generations_and_gram"] = (paths["dist_wl_nci1scale"]["warm_median_s"]
                                  - sum(st.values()))
    paths["dist_wl_nci1scale"]["stages_s"] = st
    print("dist_wl_nci1scale: %s" % {q: paths["dist_wl_nci1scale"][q]
                                      for q in ("wall_s", "warm_median_s",
                                                "wl_same_input_warm_s",
                                                "stages_s", "profiled")},
          flush=True)

    # ---------------- LargeGraphWL, NCI1-scale + arxiv-sized ----------- #
    t = time.perf_counter()
    n, s, r, lab = arxiv_sized_graph(SEED)
    big = Graph.from_arrays(n, s, r, node_labels=dict(enumerate(
        lab.tolist())))
    gen_s = time.perf_counter() - t
    mixed = graphs + [big]
    wl_big = WeisfeilerLehman(n_iter=5)
    t = time.perf_counter()
    Kb0 = wl_big.fit_transform(mixed)
    Ktb0 = wl_big.transform(held)
    wl_single_s = time.perf_counter() - t

    def large_run():
        fe = LargeGraphWL(n_iter=5, mesh=mesh)
        t = time.perf_counter()
        K = fe.fit_transform(mixed)
        t_fit = time.perf_counter() - t
        t = time.perf_counter()
        Kt = fe.transform(held)
        return K, Kt, t_fit, time.perf_counter() - t

    (K, Kt, t_fit, t_tr), secs, launches = run_path("large_wl_arxiv",
                                                    large_run)
    check(np.array_equal(K, Kb0) and np.array_equal(Kt, Ktb0),
          "large_wl_arxiv fit_transform and transform == WeisfeilerLehman("
          "n_iter=5) on the card bit for bit")
    check(launches["wl_hash_refine_rows"] == 10
          and launches["wl_hash_refine"] == 10,
          "large_wl_arxiv: the big graph on K2 reach 2 (%d launches), the "
          "rest on reach 1 (%d), once a generation a call"
          % (launches["wl_hash_refine_rows"], launches["wl_hash_refine"]))
    paths["large_wl_arxiv"] = {
        "graphs": len(mixed), "held_out": len(held), "n_iter": 5,
        "big_graph": {"vertices": n, "undirected_edges": ARXIV["edges"],
                      "labels": ARXIV["labels"], "generate_s": gen_s},
        "wall_s": secs, "fit_transform_s_first": t_fit,
        "transform_s": t_tr, "launches": launches,
        "weisfeiler_lehman_s": wl_single_s}
    paths["large_wl_arxiv"].update(warm_runs(
        lambda: LargeGraphWL(n_iter=5, mesh=mesh).fit_transform(mixed), 1))
    # the host's set-up stages of the fit, each timed alone (warm), and
    # the rest (generations and the Gram) as the warm median less them
    from grakel_torch.parallel.large_graph import (_EdgePartition,
                                                   _initial_labels)
    st, enum = {}, {}
    t = time.perf_counter()
    for g in mixed:
        _initial_labels(g, enum)
    st["initial_labels"] = time.perf_counter() - t
    t = time.perf_counter()
    _EdgePartition(big, mesh.size)
    st["edge_partition"] = time.perf_counter() - t
    st["generations_and_gram"] = (paths["large_wl_arxiv"]["warm_median_s"]
                                  - sum(st.values()))
    paths["large_wl_arxiv"]["stages_s"] = st
    print("large_wl_arxiv: %s" % {q: paths["large_wl_arxiv"][q] for q in (
        "wall_s", "fit_transform_s_first", "transform_s",
        "weisfeiler_lehman_s", "warm_median_s", "stages_s", "profiled")},
        flush=True)

    # the CPU route on a cut: a 50,000-vertex graph among the first 100
    rng = np.random.RandomState(3)
    nc = 50_000
    a, b = rng.randint(0, nc, 3 * nc), rng.randint(0, nc, 3 * nc)
    keep = a != b
    pr = np.unique(np.concatenate([a[keep], b[keep]]).astype(np.int64) * nc
                   + np.concatenate([b[keep], a[keep]]))
    cut = [Graph.from_arrays(nc, (pr // nc).astype(np.int32),
                             (pr % nc).astype(np.int32), node_labels={
                                 v: v % 5 for v in range(nc)})] + graphs[:99]
    card = LargeGraphWL(n_iter=5, mesh=mesh).fit_transform(cut)
    t = time.perf_counter()
    with use_device("cpu"):
        cpu_mesh = make_mesh()
        cpu = LargeGraphWL(n_iter=5, mesh=cpu_mesh).fit_transform(cut)
    paths["large_wl_arxiv"]["cpu_cut_s"] = time.perf_counter() - t
    check(cpu_mesh.backend == "gloo" and np.array_equal(card, cpu),
          "large_wl_arxiv on the CPU (a gloo world of one, %s) == on the "
          "card, bit for bit, on the cut (a 50,000-vertex graph among the "
          "first 100)" % cpu_mesh.backend)

    # ---------------- K2 reach 2 alone, four row blocks ----------------- #
    part1, part4 = _EdgePartition(big, 1), _EdgePartition(big, 4)
    labels = torch.from_numpy(lab.astype(np.int32)).cuda()
    glob = torch.zeros(part4.N_pad, dtype=torch.int32, device="cuda")
    glob[:n] = labels
    csr1 = part1.rank_csr(0, "cuda")
    csrs = [part4.rank_csr(p, "cuda") for p in range(4)]
    whole = wl_ops.wl_hash_refine_cuda(labels, *csr1)

    def four():
        return [wl_ops.wl_hash_refine_rows_cuda(glob, *csrs[p],
                                                p * part4.npd)
                for p in range(4)]

    got = torch.cat(four())[:n]
    plain = torch.cat([wl_ops.wl_hash_refine_csr_plain(
        glob, *csrs[p], p * part4.npd) for p in range(4)])[:n]
    torch.cuda.synchronize()
    differing = int((got != whole).sum() + (plain != whole).sum())
    check(differing == 0, "K2 reach 2 over four row blocks of the "
          "arxiv-sized graph == reach 1 over the whole graph and == its "
          "plain version, bit for bit (%d differing)" % differing)
    E = int(csr1[1].shape[0])
    # a block's offsets and targets and the gathered labels read once,
    # its keys written once; over the four blocks
    r2_bytes = 4 * (part4.N_pad + 4) + 4 * E + 4 * 4 * part4.N_pad \
        + 8 * part4.N_pad
    k2r = {"vertices": n, "directed_edges": E, "blocks": 4,
           "rows_per_block": part4.npd,
           "ms": cuda_ms(four, 50, 3),
           "device_ms": device_ms(four, 20, "wl_hash_csr", per_call=4),
           "wrapper_ms": host_ms(four, 50),
           "reach1_ms": cuda_ms(lambda: wl_ops.wl_hash_refine_cuda(
               labels, *csr1), 50, 3),
           "plain_ms": cuda_ms(lambda: [wl_ops.wl_hash_refine_csr_plain(
               glob, *csrs[p], p * part4.npd) for p in range(4)], 5),
           "bound_ms": 1e3 * r2_bytes / HBM_BYTES_PER_S, "bound_by": "bytes",
           "bytes": r2_bytes, "max_abs_err": differing}
    print("K2 reach 2 (four blocks of the arxiv-sized graph): %s" % k2r,
          flush=True)
    paths["large_wl_arxiv"]["phase_s"] = time.perf_counter() - t0
    shutdown()
    return k2r


# The JAX package's per-iteration scores for cv_mutag (WL h=5, normalized,
# on MUTAG; docs/accuracy.md's protocol), made on the CPU with
#   JAX_PLATFORMS=cpu python -c "import numpy as np; \
#   from grakel_tpu import WeisfeilerLehman; \
#   from grakel_tpu.datasets import read_data; \
#   from grakel_tpu.utils import cross_validate_Kfold_SVM as cv; \
#   b = read_data('MUTAG', path='tests/data'); \
#   K = np.asarray(WeisfeilerLehman(n_iter=5, normalize=True) \
#   .fit_transform(b.data), np.float64); \
#   print([float(s) for s in cv([K], np.asarray(b.target), n_iter=3, \
#   n_splits=10, random_state=0, C_grid=10.0 ** np.arange(-2, 5))[0]])"
CV_MUTAG_JAX = [0.7985380116959064, 0.7979532163742691, 0.8342105263157894]
CV_PROTOCOL = dict(n_iter=3, n_splits=10, random_state=0,
                   C_grid=10.0 ** np.arange(-2, 5))
# The JAX package's scores for cv_mutag_scorers: cv_mutag's Gram and
# protocol at n_iter=1, one call a scoring name (every supported name but
# accuracy, balanced_accuracy and the precision, recall and f1 forms),
# made on the CPU as CV_MUTAG_JAX is, with
#   cv([K], np.asarray(b.target), n_iter=1, n_splits=10, random_state=0,
#      C_grid=10.0 ** np.arange(-2, 5), scoring=name)
# (MUTAG's labels are -1 and 1, so the two log errors raise: their entry is
# the exception's type and message).  tests/test_torch_cv.py holds this
# dict to the JAX function.
CV_MUTAG_SCORERS_JAX = {
    "adjusted_mutual_info_score": [0.31037969885777034],
    "adjusted_rand_score": [0.40593094129222357],
    "average_precision": [0.9592407471176863],
    "completeness_score": [1.0],
    "d2_absolute_error_score": [0.4784126984126985],
    "explained_variance": [0.2413339438339439],
    "fowlkes_mallows_score": [0.7436113092275283],
    "homogeneity_score": [0.34699712715834774],
    "jaccard": [0.7755227860374918],
    "jaccard_macro": [0.6778137018210548],
    "jaccard_micro": [0.7129700734048561],
    "jaccard_weighted": [0.7150445025677223],
    "matthews_corrcoef": [0.6211696930688884],
    "mutual_info_score": [0.2125645670155658],
    "neg_max_error": [-2.0],
    "neg_mean_absolute_error": [-0.33976608187134505],
    "neg_mean_absolute_percentage_error": [-0.33976608187134505],
    "neg_mean_squared_error": [-0.6795321637426901],
    "neg_mean_squared_log_error": (
        "ValueError",
        "Mean Squared Logarithmic Error cannot be used when targets "
        "contain values less than or equal to -1."),
    "neg_median_absolute_error": [-0.2],
    "neg_negative_likelihood_ratio": [-0.14856865356865356],
    "neg_root_mean_squared_error": [-0.8119748221224803],
    "neg_root_mean_squared_log_error": (
        "ValueError",
        "Root Mean Squared Logarithmic Error cannot be used when targets "
        "contain values less than or equal to -1."),
    "normalized_mutual_info_score": [0.3465989718224099],
    "positive_likelihood_ratio": [2.265542883042883],
    "r2": [0.2173421023421024],
    "rand_score": [0.7075679394564844],
    "roc_auc": [0.9068592518592519],
    "top_k_accuracy": [1.0],
    "v_measure_score": [0.3465989718224099],
}
# adjusted_mutual_info_score's expected mutual information: the port's
# numpy exp and scipy gammaln against scikit-learn's libm exp and lgamma
CV_MUTAG_SCORERS_RTOL = {"adjusted_mutual_info_score": 1e-12}


def nci1_stand_in_labels(graphs, seed=1234):
    """Two balanced classes for the NCI1-scale set: class 1 when a
    graph's share of vertices labeled below 18 exceeds the set's median
    share, then flipped where ``RandomState(seed).rand(n) < 0.2``."""
    share = np.array([np.mean(np.fromiter(g[1].values(), np.int64) < 18)
                      for g in graphs])
    y = (share > np.median(share)).astype(np.int64)
    flip = np.random.RandomState(seed).rand(len(graphs)) < 0.2
    y[flip] = 1 - y[flip]
    return y


def _sub_batch(rec, f0, f1):
    """Fits ``f0 .. f1 - 1`` of a CV stage's record: K15's and K16's
    inputs cut to their problems and eval points (offsets rebased), and
    the card's outputs for them."""
    plan = rec["plan"]
    q0 = plan.fits[f0]["pair0"]
    q1 = plan.fits[f1 - 1]["pair0"] + plan.fits[f1 - 1]["n_pairs"]
    r0, r1 = int(plan.off[q0]), int(plan.off[q1])
    e0, e1 = int(plan.eval_off[f0]), int(plan.eval_off[f1])
    Kf, diag, ids, sign, off, C, gram = rec["smo_inputs"]
    coef, rho, iters = rec["smo_out"]
    K64, ev, _, _, _, _, models, mgram = rec["vote_inputs"]
    dec, pred = rec["vote_out"]
    m = models[f0:f1].clone()
    d0 = int(m[0, 3])
    m[:, 0] -= q0
    m[:, 2] -= e0
    m[:, 3] -= d0
    mh = m.cpu()
    npair = mh[:, 1] * (mh[:, 1] - 1) // 2
    nd = int(mh[-1, 3] + (e1 - e0 - mh[-1, 2]) * npair[-1])
    off = (off[q0:q1 + 1] - r0).contiguous()
    return {"smo": (Kf, diag, ids[r0:r1], sign[r0:r1], off, C[q0:q1],
                    gram[q0:q1]),
            "smo_out": (coef[r0:r1], rho[q0:q1], iters[q0:q1]),
            "vote": (K64, ev[e0:e1], ids[r0:r1], coef[r0:r1], off,
                     rho[q0:q1], m, mgram[f0:f1]),
            "groups": _sub_groups(plan, f0, f1, r0, r1),
            "vote_out": (dec[d0:d0 + nd], pred[e0:e1]), "problems": q1 - q0}


def _pick_problems(sub, sel):
    """K15's inputs and the card's outputs of a sub-batch cut to its
    problems ``sel`` (ascending): each problem is solved on its own, so a
    batch of some of them gives the same bits."""
    import torch
    Kf, diag, ids, sign, off, C, gram = sub["smo"]
    coef, rho, iters = sub["smo_out"]
    offh = off.cpu().numpy().astype(np.int64)
    rows = np.concatenate([np.arange(offh[p], offh[p + 1]) for p in sel])
    new_off = np.concatenate([[0], np.cumsum(np.diff(offh)[sel])])
    dev = ids.device
    r = torch.from_numpy(rows).to(dev)
    q = torch.from_numpy(np.asarray(sel, np.int64)).to(dev)
    return ((Kf, diag, ids[r], sign[r],
             torch.from_numpy(new_off.astype(np.int32)).to(dev), C[q],
             gram[q]), (coef[r], rho[q], iters[q]))


def _smo_plain_job(args):
    """``smo_plain`` in a worker process on numpy copies of its
    arguments: (its outputs as numpy arrays, host ms).  One torch thread:
    the problems are small, and the main process holds the other cores."""
    import torch
    from grakel_torch.ops import csvc
    torch.set_num_threads(1)
    args = [torch.from_numpy(a) for a in args]
    t = time.perf_counter()
    out = csvc.smo_plain(*args)
    return [o.numpy() for o in out], (time.perf_counter() - t) * 1e3


def _held(check, what, got, want):
    """Check the card's outputs ``got`` against the plain version's
    ``want`` bit for bit (on the host); returns the largest difference."""
    got = tuple(t.cpu() for t in got)
    check(all(torch_equal(g, w) for g, w in zip(got, want)), what)
    return max(float((g.double() - w.double()).abs().max()) if g.numel()
               else 0.0 for g, w in zip(got, want))


def _held_to_plain(check, name, sub):
    """K15 and K16 of the card's stage run against their plain versions
    on the CPU, on the sub-batch ``sub``; returns the plain versions'
    host ms and the largest differences."""
    from grakel_torch.ops import csvc
    cpu = lambda ts: tuple(t.cpu() for t in ts)
    t = time.perf_counter()
    want = csvc.smo_plain(*cpu(sub["smo"]))
    smo_ms = (time.perf_counter() - t) * 1e3
    err = _held(check, "%s: K15 == smo_plain bit for bit on the first "
                "outer fold's %d problems (alpha y, rho, iterations; %s "
                "iterations)" % (name, sub["problems"], want[2].tolist()),
                sub["smo_out"], want)
    t = time.perf_counter()
    want = csvc.vote_plain(*cpu(sub["vote"]))
    vote_ms = (time.perf_counter() - t) * 1e3
    err_v = _held(check, "%s: K16 == vote_plain bit for bit on the same "
                  "fits (decision values, predicted classes)" % name,
                  sub["vote_out"], want)
    return {"smo_plain_ms": smo_ms, "vote_plain_ms": vote_ms,
            "k15_max_abs_err": err, "k16_max_abs_err": err_v}


def _csvc_device_ms(smo_in, vote_in, groups=None, **kw):
    """K15's device ms a call on a stage's inputs by route ({route: ms}),
    their sum, and K16's, from torch.profiler's kernel records (one call
    each, after one warm call): the wrappers' host work (fetches,
    planning, uploads, K16's compaction) is left out.  ``kw`` goes to
    ``smo_cuda``.  A session that kept no record of a route the call
    launched, or of K16, is run again, at most twice; a kernel still
    without one is left out (K16: None)."""
    from grakel_torch.ops import csvc

    def call():
        csvc.smo_cuda(*smo_in, **kw)
        csvc.vote_cuda(*vote_in, groups=groups)

    for _ in range(3):
        by_name, _ = kernel_records(call, 1, ("csvc_smo", "csvc_vote"))
        want = set(csvc.smo_cuda.last_route)
        routes = {r: sum(v for k, v in by_name.items()
                         if "csvc_smo_" + r in k) for r in csvc.ROUTES
                  if any("csvc_smo_" + r in k for k in by_name)}
        vote = (sum(v for k, v in by_name.items() if "csvc_vote" in k)
                if any("csvc_vote" in k for k in by_name) else None)
        if set(routes) == want and vote is not None:
            break
    return routes, (sum(routes.values()) if routes else None), vote


def _smo_ms(smo_in, **kw):
    """K15's device ms of one ``smo_cuda`` call (its launches summed),
    from the profiler's kernel records; None without a record."""
    from grakel_torch.ops import csvc
    by_name, _ = kernel_records(lambda: csvc.smo_cuda(*smo_in, **kw), 1,
                                ("csvc_smo",))
    hits = [v for k, v in by_name.items() if "csvc_smo" in k]
    return sum(hits) if hits else None


def _sub_groups(plan, f0, f1, r0, r1):
    """The vote groups of fits ``f0 .. f1 - 1`` of a plan (rows ``r0 ..
    r1 - 1``), rebased: a group cut by the range keeps its fits inside."""
    groups, uni, upos = plan.vote_groups()
    first = np.maximum(groups[:, 0], f0)
    last = np.minimum(groups[:, 0] + groups[:, 1], f1)
    keep = last > first
    sub = groups[keep].copy()
    sub[:, 0] = first[keep] - f0
    sub[:, 1] = last[keep] - first[keep]
    return sub, uni, upos[r0:r1]


def _critical_path(rec):
    """A stage's serial chain: its longest problem (by iterations) run
    alone, the device ms that takes and the time an iteration takes on
    it, beside the stage's K15 ms (``share``: when it nears 1, the chain
    and not the card's throughput sets the stage's time)."""
    iters = rec["smo_out"][2].cpu().numpy()
    p = int(iters.argmax())
    inputs, outputs = _pick_problems(
        {"smo": rec["smo_inputs"], "smo_out": rec["smo_out"]}, [p])
    ms = _smo_ms(inputs)
    off = rec["plan"].off
    return {"problem": p, "iterations": int(iters[p]),
            "rows": int(off[p + 1] - off[p]), "ms_alone": ms,
            "us_per_iteration": None if ms is None
            else 1e3 * ms / max(int(iters[p]), 1)}


def _raise_before_launch(check, Km, ym):
    """SVC.fit, SVC.predict and the CV on a Gram with a NaN or an
    infinity raise scikit-learn's error before K15 or K16 launch."""
    from grakel_torch import cross_validate_Kfold_SVM as cv
    from grakel_torch.ops import csvc
    from grakel_torch.svm import SVC
    K = np.ascontiguousarray(Km[:40, :40])
    clf = SVC().fit(K[:30, :30], ym[:30])
    out = {}
    for name, value in (("nan", np.nan), ("inf", np.inf)):
        Kb = K.copy()
        Kb[3, 3] = value
        l0 = (csvc.smo_cuda.launches, csvc.vote_cuda.launches)
        msgs = []
        Pb = K[30:, :30].copy()
        Pb[4, 2] = value
        for call in (lambda: SVC().fit(Kb, ym[:40]),
                     lambda: clf.predict(Pb),
                     lambda: cv([Kb], ym[:40], n_iter=1, n_splits=3,
                                C_grid=[1.0], random_state=0)):
            try:
                call()
                msgs.append(None)
            except ValueError as e:
                msgs.append(str(e).split("\n")[0])
        l1 = (csvc.smo_cuda.launches, csvc.vote_cuda.launches)
        check(all(m is not None and m.startswith("Input X contains")
                  for m in msgs) and l1 == l0,
              "SVC.fit, SVC.predict and cross_validate_Kfold_SVM on a Gram "
              "with %s raise scikit-learn's error before any K15 or K16 "
              "launch (%s; launches %s -> %s)" % (name, msgs, l0, l1))
        out[name] = msgs
    return out


def torch_equal(a, b):
    import torch
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


def _k15_bounds(rec):
    """K15's least time on a stage: the larger of its inputs read and its
    outputs written once over 3.35 TB/s and 4 f64 operations (the G
    update's two products and two sums) an active row an iteration over
    the f64 rate; beside it the count of two Q rows of l f32 entries
    read an iteration."""
    plan = rec["plan"]
    Kf = rec["smo_inputs"][0]
    R, P = int(plan.off[-1]), plan.n_problems
    nbytes = Kf.numel() * 4 + Kf.shape[0] * Kf.shape[1] * 8 \
        + R * 5 + P * (4 + 8 + 4) + R * 8 + P * (8 + 4)
    b = bound(nbytes, 4 * rec["active_rows"], FP64_VECTOR_OPS_PER_S)
    iters = rec["smo_out"][2].cpu().numpy().astype(np.int64)
    q_bytes = int((iters * 2 * np.diff(plan.off) * 4).sum())
    b["bound_ms_q_rows"] = 1e3 * q_bytes / HBM_BYTES_PER_S
    b["q_row_bytes"] = q_bytes
    return b


def _k16_bounds(rec):
    """K16's least time on a stage: the Gram entries it needs (each eval
    point's entries at its model's rows of nonzero coefficients, each
    distinct entry once), the problems' rows and the outputs once over
    3.35 TB/s, and a product and a sum an (eval point, nonzero row of its
    pair) over the f64 rate."""
    plan = rec["plan"]
    K64 = rec["vote_inputs"][0]
    coef = rec["smo_out"][0].cpu().numpy()
    pts = np.diff(plan.eval_off)
    need = np.zeros((K64.shape[0], K64.shape[1], K64.shape[2]), bool)
    nbytes = int(plan.off[-1]) * (4 + 8) + plan.n_problems * 12
    ops = 0
    for f, m in enumerate(plan.fits):
        lo = int(plan.off[m["pair0"]])
        hi = int(plan.off[m["pair0"] + m["n_pairs"]])
        nz = coef[lo:hi] != 0
        ev = plan.eval_ids[plan.eval_off[f]:plan.eval_off[f + 1]]
        need[m["gram"]][np.ix_(ev, np.unique(plan.ids[lo:hi][nz]))] = True
        nbytes += int(pts[f]) * (4 + 8 * m["n_pairs"])
        ops += 2 * int(pts[f]) * int(nz.sum())
    return dict(bound(nbytes + 8 * int(need.sum()), ops,
                      FP64_VECTOR_OPS_PER_S), gram_entries=int(need.sum()))


def cv_phase(run_path, check, paths, train):
    """``cross_validate_Kfold_SVM`` on the card (the slice of K15 and
    K16): ``cv_nci1scale`` (WL-VH h=5, normalized, on the 4110
    NCI1-scale graphs with :func:`nci1_stand_in_labels`, the default
    protocol: 700 inner fits of 3329 rows and 100 refits of 3699, K15's
    block route), K15 and K16 held to their plain versions on the first
    outer fold's 7 inner fits and its refit; ``cv_mutag`` (WL h=5 on
    MUTAG, docs/accuracy.md's protocol, the block route), its scores
    equal to the JAX package's and to the CPU route; ``cv_cuneiform``
    (GraphHopper on Cuneiform, 30 classes, the same protocol: up to 435
    pairs a fit, the warp route), equal to the CPU route on a cut, and
    K15 and K16 held to their plain versions on the inner fit that holds
    the stage's longest problem (K15 on its four pairs of the most
    iterations, in a worker process while the other paths run; K16 on
    all its pairs).  Each path launches K15 once a route a stage and K16
    once a stage; each stage's K15 ms by route, K16 ms and critical path
    (its longest problem alone) are measured.  Also: SVC and the CV
    raise on a NaN or an infinity before any launch; the warp route's
    row limit swept on Cuneiform's and MUTAG's inner stages, the block
    route's threads on NCI1's, the global route on its first fold.
    ``cv_nci1scale_auc`` reruns ``cv_nci1scale`` with ``scoring="roc_auc"``
    (its launches as ``cv_nci1scale``'s; the first outer fold's refit
    score equal to roc_auc of ``vote_plain``'s decision values on the
    CPU); ``cv_mutag_scorers`` runs ``cv_mutag``'s Gram and protocol at
    one iteration with each of the 30 names of
    ``CV_MUTAG_SCORERS_JAX``, each name's scores (or error) equal to the
    JAX package's, K15 and K16 once a stage.
    Returns K15's and K16's rows for the kernels line."""
    import multiprocessing
    import torch
    from grakel_torch import (GraphHopper, WeisfeilerLehman,
                              cross_validate_Kfold_SVM as cv, use_device)
    from grakel_torch.datasets import read_data
    from grakel_torch.metrics import roc_auc_score
    from grakel_torch.ops import csvc

    t0 = time.perf_counter()
    cv.keep_last = True        # each stage's tensors, for the holds below
    data = os.path.join(HERE, "tests", "data")
    mb = read_data("MUTAG", path=data)
    Km = WeisfeilerLehman(n_iter=5, normalize=True).fit_transform(mb.data)
    ym = np.asarray(mb.target)
    raised = _raise_before_launch(check, Km, ym)

    def card_path(name, K, y, route, **kw):
        for r in csvc.smo_cuda.route_launches:
            csvc.smo_cuda.route_launches[r] = 0
        scores, secs, launches = run_path(name, lambda: cv([K], y, **kw))
        stages = cv.last["stages"]
        by_route = dict(csvc.smo_cuda.route_launches)
        taken = [sorted(st["route"]) for st in stages]
        check(launches["csvc_smo"] == sum(len(r) for r in taken)
              and launches["csvc_vote"] == 2
              and all(by_route[r] == sum(r in t for t in taken)
                      for r in csvc.ROUTES)
              and taken == [[route], [route]],
              "%s launched K15 once a route a stage, all on its %s route, "
              "and K16 once a stage (K15 %d: %s, stages' routes %s; K16 %d)"
              % (name, route, launches["csvc_smo"], by_route, taken,
                 launches["csvc_vote"]))
        check(len(scores) == 1 and len(scores[0]) == kw.get("n_iter", 10)
              and all(np.isfinite(s) and 0 <= s <= 1 for s in scores[0]),
              "%s: %d finite scores in [0, 1]" % (name, len(scores[0])))
        info = {"wall_s": secs, "launches": launches,
                "k15_route_launches": by_route, "scores": [
                    float(s) for s in scores[0]], "stages": []}
        for st in stages:
            row = {k: st[k] for k in ("problems", "max_rows", "iterations",
                                      "active_rows", "route")}
            routes, row["k15_ms"], row["k16_ms"] = _csvc_device_ms(
                st["smo_inputs"], st["vote_inputs"],
                st["plan"].vote_groups())
            row["k15_ms_by_route"] = routes
            check(row["k15_ms"] is not None and row["k16_ms"] is not None
                  and set(routes) == set(st["route"]),
                  "%s: the profiler kept K15's records of each route and "
                  "K16's (%s, %s ms)" % (name, routes, row["k16_ms"]))
            row["critical_path"] = _critical_path(st)
            cp = row["critical_path"]["ms_alone"]
            row["critical_path"]["share"] = (
                None if cp is None or not row["k15_ms"]
                else cp / row["k15_ms"])
            info["stages"].append(row)
        paths[name] = info
        print("%s: %s" % (name, info), flush=True)
        return scores, stages

    def warp_sweep(name, st, limits):
        """K15 on a stage's inputs at several warp route limits: the
        same bits as the path's launch, the device ms of each."""
        out = {}
        for w in limits:
            got = csvc.smo_cuda(*st["smo_inputs"], warp_rows=w)
            check(all(torch_equal(g, x) for g, x in zip(got, st["smo_out"])),
                  "%s: K15 with the warp route up to %d rows == the path's "
                  "launch bit for bit" % (name, w))
            out[w] = {"ms": _smo_ms(st["smo_inputs"], warp_rows=w),
                      "routes": sorted(csvc.smo_cuda.last_route)}
        print("%s: K15's device ms on the inner stage by the warp route's "
              "row limit %s" % (name, out), flush=True)
        return out

    # ---------------- cv_cuneiform: 30 classes ------------------------- #
    cb = read_data("Cuneiform", path=data, prefer_attr_nodes=True)
    Kc = GraphHopper(normalize=True).fit_transform(cb.data)
    yc = np.asarray(cb.target)
    _, stages = card_path("cv_cuneiform", Kc, yc, "warp", **CV_PROTOCOL)
    paths["cv_cuneiform"]["warp_rows_sweep"] = warp_sweep(
        "cv_cuneiform", stages[0], (0, 32, 64, 128, 192))
    # the inner fit that holds the stage's longest problem: K15's long
    # tail (shrinking, the unshrink and the gradient's reconstruction on
    # the multiclass path).  smo_plain runs a problem's iterations one
    # by one (~1 ms each on the host), so the fit's four pairs of the
    # most iterations are held, in a worker process while the other
    # paths run
    plan = stages[0]["plan"]
    longest = int(stages[0]["smo_out"][2].argmax())
    f_long = int(np.searchsorted([f["pair0"] for f in plan.fits], longest,
                                 side="right")) - 1
    n_C = len(CV_PROTOCOL["C_grid"])
    it_fold, c_long = divmod(f_long, n_C)
    tail_fit = "iteration %d, fold %d, C = %g" % (
        *divmod(it_fold, CV_PROTOCOL["n_splits"]),
        CV_PROTOCOL["C_grid"][c_long])
    tail = _sub_batch(stages[0], f_long, f_long + 1)
    it_tail = tail["smo_out"][2].cpu().numpy()
    sel = np.sort(np.argsort(-it_tail, kind="stable")[:4])
    tail_in, tail_out = _pick_problems(tail, sel)
    check(max(int(x) for x in np.diff(tail["smo"][4].cpu().numpy())[sel])
          <= csvc.K15_WARP_ROWS,
          "cv_cuneiform: the tail hold's pairs took the warp route")
    pool = multiprocessing.get_context("spawn").Pool(1)
    try:
        job = pool.apply_async(_smo_plain_job,
                               ([t_.cpu().numpy() for t_ in tail_in],))
        pool.close()
        t = time.perf_counter()
        want = csvc.vote_plain(*(t_.cpu() for t_ in tail["vote"]))
        tail_vote_ms = (time.perf_counter() - t) * 1e3
        tail_k16_err = _held(
            check, "cv_cuneiform: K16 == vote_plain bit for bit on the "
            "fit of the inner stage's longest problem (%s, %d pairs)"
            % (tail_fit, tail["problems"]),
            tail["vote_out"], want)
        del stages, plan, tail
        cv.last = None

        # -------------- cv_nci1scale: the default protocol, not cut ---- #
        t = time.perf_counter()
        Kn = WeisfeilerLehman(n_iter=5, normalize=True).fit_transform(train)
        gram_s = time.perf_counter() - t
        y = nci1_stand_in_labels(train)
        _, stages = card_path("cv_nci1scale", Kn, y, "block",
                              random_state=0)
        st1, st2 = stages
        print("cv_nci1scale: the first outer fold's inner iterations %s, "
              "its refit's %s" % (st1["smo_out"][2][:7].tolist(),
                                  st2["smo_out"][2][:1].tolist()),
              flush=True)
        check(st1["problems"] == 700 and st1["max_rows"] == 3329
              and st2["problems"] == 100 and st2["max_rows"] == 3699,
              "cv_nci1scale: 700 inner problems of at most 3329 rows and "
              "100 refits of at most 3699 (%d / %d, %d / %d)"
              % (st1["problems"], st1["max_rows"], st2["problems"],
                 st2["max_rows"]))
        sub1 = _sub_batch(st1, 0, 7)
        sub2 = _sub_batch(st2, 0, 1)
        held1 = _held_to_plain(check, "cv_nci1scale inner fits", sub1)
        held2 = _held_to_plain(check, "cv_nci1scale refit", sub2)
        # K15's block size on the block route (8 rows a thread from 417
        # to 512 threads at 3329 rows): every size gives the same bits
        # (the reductions keep libsvm's order of ties); the first fold's
        # 7 problems and the whole inner stage
        sweep, sweep_stage = {}, {}
        for T in (448, 480, 512):
            out = csvc.smo_cuda(*sub1["smo"], threads=T)
            check(all(torch_equal(g, w) for g, w in zip(out,
                                                        sub1["smo_out"])),
                  "cv_nci1scale: K15 at %d threads == the path's launch "
                  "bit for bit" % T)
            sweep[T] = _smo_ms(sub1["smo"], threads=T)
            out = csvc.smo_cuda(*st1["smo_inputs"], threads=T)
            check(all(torch_equal(g, w) for g, w in zip(out,
                                                        st1["smo_out"])),
                  "cv_nci1scale: K15 on the inner stage at %d threads == "
                  "the path's launch bit for bit" % T)
            sweep_stage[T] = _smo_ms(st1["smo_inputs"], threads=T)
        print("cv_nci1scale: K15's device ms by threads a block on the "
              "first fold's 7 problems %s, on the inner stage %s"
              % (sweep, sweep_stage), flush=True)
        # the global route (the first design's kernel) on the same 7
        # problems
        out = csvc.smo_cuda(*sub1["smo"], block_rows=0)
        check(all(torch_equal(g, w) for g, w in zip(out, sub1["smo_out"]))
              and list(csvc.smo_cuda.last_route) == ["global"],
              "cv_nci1scale: K15's global route on the first fold == the "
              "path's launch bit for bit")
        global_ms = _smo_ms(sub1["smo"], block_rows=0)
        first = _csvc_device_ms(sub1["smo"], sub1["vote"], sub1["groups"])
        stage_ms = {p: [(s["k15_ms"], s["k16_ms"]) for s in paths[p][
            "stages"]] for p in ("cv_cuneiform", "cv_nci1scale")}
        k15 = {"ms": paths["cv_nci1scale"]["stages"][0]["k15_ms"],
               "ms_by_route": {
                   "block": paths["cv_nci1scale"]["stages"][0]["k15_ms"],
                   "warp": paths["cv_cuneiform"]["stages"][0]["k15_ms"],
                   "global": global_ms},
               "ms_by_route_shapes": "block: cv_nci1scale's inner stage "
                                     "(700 problems of 3329 rows); warp: "
                                     "cv_cuneiform's (91,350 of ~18); "
                                     "global: cv_nci1scale's first fold "
                                     "(7 problems)",
               "stage_ms": stage_ms,
               "critical_path": {p: [s["critical_path"] for s in paths[p][
                   "stages"]] for p in ("cv_cuneiform", "cv_nci1scale")},
               "threads_sweep_first_fold_ms": sweep,
               "threads_sweep_stage_ms": sweep_stage,
               "warp_rows_sweep_cuneiform": paths["cv_cuneiform"][
                   "warp_rows_sweep"],
               "ms_first_fold": first[1], "ms_global_first_fold": global_ms,
               "plain_ms": held1["smo_plain_ms"],
               "max_abs_err": max(held1["k15_max_abs_err"],
                                  held2["k15_max_abs_err"]),
               **_k15_bounds(st1)}
        k16 = {"ms": paths["cv_nci1scale"]["stages"][0]["k16_ms"],
               "stage_ms": {p: [x[1] for x in v]
                            for p, v in stage_ms.items()},
               "ms_first_fold": first[2],
               "plain_ms": held1["vote_plain_ms"],
               "max_abs_err": max(held1["k16_max_abs_err"],
                                  held2["k16_max_abs_err"],
                                  tail_k16_err),
               **_k16_bounds(st1)}
        paths["cv_nci1scale"].update(gram_s=gram_s,
                                     held_to_plain=[held1, held2],
                                     classes=np.bincount(y).tolist())
        del stages, st1, st2, sub1, sub2
        cv.last = None
        torch.cuda.empty_cache()

        # -------------- cv_nci1scale_auc: roc_auc from K16's values ----- #
        # the same protocol and Gram; each fit's score reads its decision
        # values from the stage's one K16 launch (no launch added)
        folds = []

        def keep_folds(fold_scores):
            folds.append(list(fold_scores))
            return np.mean(fold_scores)

        auc, secs, launches = run_path(
            "cv_nci1scale_auc", lambda: cv([Kn], y, random_state=0,
                                           scoring="roc_auc",
                                           fold_reduce=keep_folds))
        stages = cv.last["stages"]
        taken = [sorted(st["route"]) for st in stages]
        ref = paths["cv_nci1scale"]["launches"]
        check(launches["csvc_smo"] == ref["csvc_smo"]
              == sum(len(r) for r in taken)
              and launches["csvc_vote"] == ref["csvc_vote"] == 2
              and taken == [["block"], ["block"]],
              "cv_nci1scale_auc launched K15 and K16 as cv_nci1scale did "
              "(K15 %d: routes %s; K16 %d; cv_nci1scale %d, %d)"
              % (launches["csvc_smo"], taken, launches["csvc_vote"],
                 ref["csvc_smo"], ref["csvc_vote"]))
        check(len(auc[0]) == 10 and all(np.isfinite(s) and 0 <= s <= 1
                                        for s in auc[0]),
              "cv_nci1scale_auc: 10 finite scores in [0, 1] (%s)"
              % [float(s) for s in auc[0]])
        # the first outer fold's refit: roc_auc of vote_plain's decision
        # values on the CPU, oriented as SVC.decision_function orients them
        st2 = stages[1]
        sub2 = _sub_batch(st2, 0, 1)
        dec = csvc.vote_plain(*(t_.cpu() for t_ in sub2["vote"]))[0]
        plan = st2["plan"]
        ev = plan.eval_ids[plan.eval_off[0]:plan.eval_off[1]]
        want = roc_auc_score(y[ev], -dec.numpy().ravel())
        check(folds[0][0] == want,
              "cv_nci1scale_auc: the first outer fold's refit score %r == "
              "roc_auc of vote_plain's decision values on the CPU %r"
              % (float(folds[0][0]), float(want)))
        paths["cv_nci1scale_auc"] = {
            "wall_s": secs, "wall_s_accuracy": paths["cv_nci1scale"][
                "wall_s"], "launches": launches, "k15_routes": taken,
            "scores": [float(s) for s in auc[0]],
            "first_fold_refit": float(folds[0][0])}
        print("cv_nci1scale_auc: %.3f s (cv_nci1scale, accuracy: %.3f s); "
              "scores %s" % (secs, paths["cv_nci1scale"]["wall_s"],
                             paths["cv_nci1scale_auc"]["scores"]),
              flush=True)
        del stages, st2, sub2, Kn
        cv.last = None
        torch.cuda.empty_cache()

        # -------------- cv_mutag: the JAX package's scores ------------- #
        scores, stages = card_path("cv_mutag", Km, ym, "block",
                                   **CV_PROTOCOL)
        check([float(s) for s in scores[0]] == CV_MUTAG_JAX,
              "cv_mutag scores == the JAX package's %s bit for bit (%s)"
              % (CV_MUTAG_JAX, [float(s) for s in scores[0]]))
        paths["cv_mutag"]["warp_rows_sweep"] = warp_sweep(
            "cv_mutag", stages[0], (0, 64, 128, 192))
        k15["warp_rows_sweep_mutag"] = paths["cv_mutag"]["warp_rows_sweep"]
        k15["stage_ms"]["cv_mutag"] = [(s["k15_ms"], s["k16_ms"])
                                       for s in paths["cv_mutag"]["stages"]]
        del stages
        cv.last = None
        t = time.perf_counter()
        with use_device("cpu"):
            cpu = cv([Km], ym, **CV_PROTOCOL)
        paths["cv_mutag"]["cpu_route_s"] = time.perf_counter() - t
        check(cpu == scores, "cv_mutag == the CPU route exactly")

        # -------------- cv_mutag_scorers: the other 30 names ------------ #
        # cv_mutag's Gram and protocol at n_iter=1, a call a name: its
        # scores, or its error, as the JAX package's (CV_MUTAG_SCORERS_JAX)
        one = dict(CV_PROTOCOL, n_iter=1)
        by_name = {}

        def every_scorer():
            for name in CV_MUTAG_SCORERS_JAX:
                l0 = (csvc.smo_cuda.launches, csvc.vote_cuda.launches,
                      dict(csvc.smo_cuda.route_launches))
                t = time.perf_counter()
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    try:
                        got = [float(s) for s in
                               cv([Km], ym, scoring=name, **one)[0]]
                    except Exception as e:   # held to the JAX package's
                        got = (type(e).__name__, str(e))
                torch.cuda.synchronize()
                by_name[name] = {
                    "scores": got, "s": time.perf_counter() - t,
                    "launches": (csvc.smo_cuda.launches - l0[0],
                                 csvc.vote_cuda.launches - l0[1]),
                    "routes": {r: n - l0[2][r] for r, n in
                               csvc.smo_cuda.route_launches.items()
                               if n > l0[2][r]}}

        _, secs, launches = run_path("cv_mutag_scorers", every_scorer)
        for name, want in CV_MUTAG_SCORERS_JAX.items():
            got = by_name[name]
            rtol = CV_MUTAG_SCORERS_RTOL.get(name)
            same = got["scores"] == want or (
                rtol is not None and isinstance(want, list)
                and isinstance(got["scores"], list)
                and np.allclose(got["scores"], want, rtol=rtol, atol=0))
            check(same, "cv_mutag_scorers: %s == the JAX package's %r (%r)"
                  % (name, want, got["scores"]))
            # a stage a K16 launch and a block-route K15 launch: two
            # stages, or one where the first stage's scorer raises
            n_st = 2 if isinstance(want, list) else 1
            check(got["launches"] == (n_st, n_st)
                  and got["routes"] == {"block": n_st},
                  "cv_mutag_scorers: %s launched K15 once a stage on its "
                  "block route and K16 once a stage (%d stages; K15, K16 "
                  "%s, routes %s)" % (name, n_st, got["launches"],
                                      got["routes"]))
        paths["cv_mutag_scorers"] = {"wall_s": secs, "launches": launches,
                                     "by_name": by_name}
        print("cv_mutag_scorers: %.3f s for the %d names; %s"
              % (secs, len(by_name), by_name), flush=True)

        # -------------- cv_cuneiform against the CPU route ------------- #
        # the CPU route runs libsvm's steps in torch, the problems of a
        # stage in lockstep: seconds on a cut of the protocol (one
        # iteration, C up to 10), minutes on the whole (its C = 1e4 pairs
        # take tens of thousands of iterations; the tail hold above
        # covers them)
        cut = dict(CV_PROTOCOL, n_iter=1, C_grid=10.0 ** np.arange(-2, 2))
        card = cv([Kc], yc, **cut)
        t = time.perf_counter()
        with use_device("cpu"):
            cpu = cv([Kc], yc, **cut)
        paths["cv_cuneiform"]["cpu_route_s"] = time.perf_counter() - t
        paths["cv_cuneiform"]["cpu_route_cut"] = "n_iter=1, C_grid=1e-2..1e1"
        check(cpu == card, "cv_cuneiform == the CPU route exactly on a cut "
              "(one iteration, C_grid 1e-2..1e1: %s)" % card)
        t = time.perf_counter()
        want, tail_smo_ms = job.get(timeout=900)
        want = tuple(torch.from_numpy(w) for w in want)
        wait_s = time.perf_counter() - t
    finally:
        pool.terminate()
        pool.join()
    tail_k15_err = _held(
        check, "cv_cuneiform: K15 == smo_plain bit for bit on the 4 pairs "
        "of the most iterations of the fit of the inner stage's longest "
        "problem (%s; %s iterations)" % (tail_fit, want[2].tolist()),
        tail_out, want)
    k15["max_abs_err"] = max(k15["max_abs_err"], tail_k15_err)
    paths["cv_cuneiform"]["tail_hold"] = {
        "fit": tail_fit,
        "k15_pairs_iterations": want[2].tolist(),
        "fit_iterations_max": int(it_tail.max()),
        "smo_plain_ms": tail_smo_ms, "vote_plain_ms": tail_vote_ms,
        "waited_s": wait_s}
    print("cv_cuneiform tail hold: %s" % paths["cv_cuneiform"]["tail_hold"],
          flush=True)
    paths["cv_cuneiform"]["classes"] = int(np.unique(yc).shape[0])
    paths["cv_mutag"]["raise_before_launch"] = raised
    cv.keep_last, cv.last = False, None
    paths["cv_cuneiform"]["phase_s"] = time.perf_counter() - t0
    common = {"route": "cuda", "source": "grakel_torch/csrc/csvc.cu",
              "library_ms": None,
              "library": "none: no single PyTorch call solves an SVM or "
                         "takes its one-vs-one vote",
              "shapes": "cv_nci1scale stage 1: 700 binary problems of "
                        "3329 rows, 370 eval points each (ms: the "
                        "profiler's kernel records); ms_first_fold and "
                        "plain_ms (the plain version on the CPU, host "
                        "ms) on the first outer fold's 7 problems"}
    return [
        {"name": "csvc_smo", "replaces": "grakel_tpu/utils.py:134",
         **common, **k15},
        {"name": "csvc_vote", "replaces": "grakel_tpu/utils.py:135",
         **common, **k16}]


def gram_norm_phase(run_path, check, paths, train):
    """The float64 normalization on the card (K17, ``csrc/gram_norm.cu``):
    ``wl_norm_nci1scale`` (``WeisfeilerLehman(n_iter=5,
    normalize=True)`` on the 4110 NCI1-scale graphs) must launch K17
    exactly once and equal the unnormalized Gram's host normalization
    (``ops.gram.normalize_gram`` on numpy) bit for bit; then K17 alone on
    that Gram, f32 as the path hands it and f64, against the host route
    bit for bit and timed beside its bound (bytes: K read once, the f64
    Gram written once, the diagonals once), the host route (plain ms,
    host clock) and the pageable fetch of the f32 Gram and of the f64
    result.  Returns K17's kernel row."""
    import torch
    from grakel_torch import WeisfeilerLehman
    from grakel_torch.ops import gram as gram_ops
    t0 = time.perf_counter()
    K, secs, launches = run_path(
        "wl_norm_nci1scale",
        lambda: WeisfeilerLehman(n_iter=5, normalize=True).fit_transform(
            train))
    check(launches["gram_normalize"] == 1,
          "wl_norm_nci1scale launched K17 once (%d)"
          % launches["gram_normalize"])
    raw = WeisfeilerLehman(n_iter=5).fit_transform(train)
    d = np.diagonal(raw).copy()
    want = gram_ops.normalize_gram(raw, d, d)
    check(K.dtype == np.float64 and np.array_equal(K, want),
          "wl_norm_nci1scale == its f32 Gram normalized on the host, bit "
          "for bit")
    paths["wl_norm_nci1scale"] = {"graphs": len(train), "wall_s": secs,
                                  "launches": launches}
    m = raw.shape[0]
    dd = torch.from_numpy(d.astype(np.float64)).cuda()
    shapes = []
    for dt in (torch.float32, torch.float64):
        Kc = torch.from_numpy(raw).cuda().to(dt)
        host = raw.astype(np.float64 if dt == torch.float64 else np.float32)
        t = time.perf_counter()
        ref = gram_ops.normalize_gram(host, d, d)
        plain_ms = (time.perf_counter() - t) * 1e3
        out = gram_ops.normalize_gram_cuda(Kc, dd, dd)
        torch.cuda.synchronize()
        ok = np.array_equal(out.cpu().numpy(), ref)
        check(ok, "K17 %s %dx%d == the host route bit for bit"
              % (str(dt)[6:], m, m))
        ms = cuda_ms(lambda: gram_ops.normalize_gram_cuda(Kc, dd, dd), 50)
        nbytes = m * m * (Kc.element_size() + 8) + 2 * m * 8
        shapes.append({"dtype": str(dt)[6:], "m": m, "n": m, "ms": ms,
                       "plain_ms": plain_ms, "bit_equal": ok,
                       **bound(nbytes, 3 * m * m, FP64_VECTOR_OPS_PER_S)})
        print("K17 %s %dx%d: %.4f ms (bound %.4f, %s), host route %.1f ms"
              % (str(dt)[6:], m, m, ms, shapes[-1]["bound_ms"],
                 shapes[-1]["bound_by"], plain_ms), flush=True)
        del Kc, out
    fetch = {}
    for name, dt in (("f32", torch.float32), ("f64", torch.float64)):
        X = torch.from_numpy(raw).cuda().to(dt)
        runs = []
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            X.cpu()
            runs.append((time.perf_counter() - t) * 1e3)
        fetch[name] = sorted(runs)[2]
    print("pageable fetch of the %dx%d Gram (median of 5, host ms): %s"
          % (m, m, fetch), flush=True)
    paths["wl_norm_nci1scale"]["phase_s"] = time.perf_counter() - t0
    main = shapes[0]
    return [{"name": "gram_normalize", "route": "cuda",
             "source": "grakel_torch/csrc/gram_norm.cu",
             "replaces": "none: the host's float64 normalization "
                         "(grakel_tpu/ops/gram.py normalize_gram, numpy)",
             **{k: main[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "bytes")},
             "max_abs_err": 0.0 if all(c["bit_equal"] for c in shapes)
             else None,
             "library_ms": None,
             "library": "none: one PyTorch call does not compute it, and "
                        "torch's CPU sqrt is not numpy's",
             "fetch_ms": fetch,
             "shapes": shapes}]


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import grakel_torch  # noqa: F401
    except ImportError as e:
        print("chip_smoke: grakel_torch is not importable next to this "
              "script (%s); run it from the repository" % e,
              file=sys.stderr)
        return 2
    from grakel_torch import (Graph, GraphKernel, HadamardCode, Propagation,
                              PropagationAttr, PyramidMatch, ShortestPath,
                              WeisfeilerLehman,
                              WeisfeilerLehmanOptimalAssignment, use_device,
                              _build, native)
    from grakel_torch.batch import GraphBatch
    from grakel_torch.datasets import generate_dataset, read_data
    from grakel_torch.kernels import shortest_path as sp_mod
    from grakel_torch.kernels.base import normalize_input
    from grakel_torch.ops import floyd_warshall as fw_ops
    from grakel_torch.ops import hadamard as hc_ops
    from grakel_torch.ops import intersect, nh as nh_ops, wl as wl_ops

    t_start = time.perf_counter()
    check = Checks()
    torch.cuda.set_device(0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    smi = smi[0].strip() if smi else "nvidia-smi: no output"
    print("device: %s (torch %s, CUDA %s); %s"
          % (kind, torch.__version__, torch.version.cuda, smi), flush=True)

    t0 = time.perf_counter()
    # the native host engines (g++) build beside the CUDA kernels (nvcc)
    native_build = {}

    def build_native():
        try:
            native_build["path"] = _build.build_native()
        except RuntimeError as e:
            native_build["error"] = str(e)
        native_build["s"] = time.perf_counter() - t0

    import threading
    native_thread = threading.Thread(target=build_native)
    native_thread.start()
    lib_path, nvcc_out = _build.build(verbose=True)
    _build.load_library()
    build_s = time.perf_counter() - t0
    native_thread.join()
    print("build: %.2f s -> %s" % (build_s, os.path.relpath(lib_path, HERE)),
          flush=True)
    if "error" in native_build:
        print(native_build["error"], file=sys.stderr)
        check(False, "native engines built")
        return 1
    native._load()
    print("native build: %.2f s -> %s" % (
        native_build["s"], os.path.relpath(native_build["path"], HERE)),
        flush=True)
    for line in nvcc_out.splitlines():   # ptxas: registers, smem, spills
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print("  " + line.strip(), flush=True)
    k3_ptxas = {k: v for k, v in ptxas_info(nvcc_out).items()
                if k.startswith("fw_")}
    check(len(k3_ptxas) == 8 and all(
        v.get("spill_stores") == 0 and v.get("spill_loads") == 0
        for v in k3_ptxas.values()),
        "K3's 8 kernels built without spills: %s" % k3_ptxas)
    k1_ptxas = {k: v for k, v in ptxas_info(nvcc_out).items()
                if k.startswith("min_gram_kernel")}
    check(len(k1_ptxas) == 3 * len(intersect.K1_TILES) and all(
        v.get("spill_stores") == 0 and v.get("spill_loads") == 0
        for v in k1_ptxas.values()),
        "K1's %d kernels built without spills: %s"
        % (3 * len(intersect.K1_TILES), k1_ptxas))
    k45_ptxas = {k: v for k, v in ptxas_info(nvcc_out).items()
                 if "nh_graph" in k or "nh_round" in k or "jaccard" in k}
    check(len(k45_ptxas) == 13 and all(
        v.get("spill_stores") == 0 and v.get("spill_loads") == 0
        for v in k45_ptxas.values()),
        "K4's 4 and K5's 9 kernels built without spills: %s" % k45_ptxas)

    k789_ptxas = {k: v for k, v in ptxas_info(nvcc_out).items()
                  if "canonical" in k or "rw_cg" in k or "rw_spectral" in k}
    check(len(k789_ptxas) == 17 and all(
        v.get("spill_stores") == 0 and v.get("spill_loads") == 0
        for v in k789_ptxas.values()),
        "K7's 8 (s = 2..8, s = 8 on both table placements), K8's 8 (2 "
        "block routes, 6 warp route) and K9's 1 kernels built without "
        "spills: %s" % k789_ptxas)
    tc_ptxas = {k: v for k, v in ptxas_info(nvcc_out).items()
                if "min_gram_tc" in k or "threshold_expand" in k}
    check(len(tc_ptxas) == len(intersect.TC_TILES) + 2 and all(
        v.get("spill_stores") == 0 and v.get("spill_loads") == 0
        for v in tc_ptxas.values()),
        "K1-tc's %d kernels (its %d tiles, the expansion, the mma.sync "
        "design) "
        "built without spills: %s" % (len(intersect.TC_TILES) + 2,
                                      len(intersect.TC_TILES), tc_ptxas))

    k6_ptxas = {k: v for k, v in ptxas_info(nvcc_out).items()
                if "hadamard" in k}
    check(len(k6_ptxas) == 14 and all(
        v.get("spill_stores") == 0 and v.get("spill_loads") == 0
        for v in k6_ptxas.values()),
        "K6's 14 kernels (10 round route, 4 graph route) built without "
        "spills: %s" % k6_ptxas)
    from grakel_torch.ops import lovasz_sdp as lovasz_ops
    k1013_ptxas = {k: v for k, v in ptxas_info(nvcc_out).items()
                   if "svm_" in k or "lovasz_" in k}
    check(len(k1013_ptxas) == 26 and all(
        v.get("spill_stores") == 0 and v.get("spill_loads") == 0
        for v in k1013_ptxas.values()),
        "K10 and K11's 5 kernels, each running both (route warp at V = 8, "
        "16, 32, 64; route block), K12's 7 (route tile at V = 4, 8, "
        "16, 32, 64, 128; route global), K13's 12 (route register at d "
        "<= %s; routes shared and global) and K14's 2 (a warp, a block a "
        "matrix) built without spills: %s"
        % ("/".join(map(str, lovasz_ops.K13_REG_D)), k1013_ptxas))

    from grakel_torch.ops import canonical as can_ops
    from grakel_torch.ops import random_walk as rw_ops
    from grakel_torch.ops import svm_qp as svm_ops
    from grakel_torch.ops import csvc as csvc_ops
    k1516_ptxas = {k: v for k, v in ptxas_info(nvcc_out).items()
                   if "csvc" in k}
    check(len(k1516_ptxas) == 9 and all(
        v.get("spill_stores") == 0 and v.get("spill_loads") == 0
        for v in k1516_ptxas.values()),
        "K15's 8 kernels (route warp; route block at 1, 2, 3, 4, 6 and 8 "
        "rows a thread; route global) and K16's built without spills: %s"
        % k1516_ptxas)
    from grakel_torch.ops import gram as gram_ops
    k17_ptxas = {k: v for k, v in ptxas_info(nvcc_out).items()
                 if "gram_normalize" in k}
    check(len(k17_ptxas) == 2 and all(
        v.get("spill_stores") == 0 and v.get("spill_loads") == 0
        for v in k17_ptxas.values()),
        "K17's 2 kernels (f32 and f64 K) built without spills: %s"
        % k17_ptxas)
    counters = {"min_gram": intersect.min_gram_cuda,
                "min_gram_tc": intersect.min_gram_tc_cuda,
                "threshold_expand": intersect.threshold_expand_cuda,
                "wl_hash_refine": wl_ops.wl_hash_refine_cuda,
                "wl_hash_refine_rows": wl_ops.wl_hash_refine_rows_cuda,
                "floyd_warshall": fw_ops.floyd_warshall_cuda,
                "nh_graph": nh_ops.nh_graph_cuda,
                "nh_round": nh_ops.nh_round_cuda,
                "jaccard_fold": intersect.jaccard_fold_cuda,
                "hadamard_graph": hc_ops.hadamard_graph_cuda,
                "hadamard_step": hc_ops.hadamard_step_cuda,
                "canonical": can_ops.canonical_codes_cuda,
                "rw_cg": rw_ops.pair_cg_cuda,
                "rw_spectral": rw_ops.spectral_gram_cuda,
                "svm_lanczos": svm_ops.lanczos_cuda,
                "svm_fista": svm_ops.fista_cuda,
                "svm_solve": svm_ops.solve_cuda,
                "lovasz_dr_step": lovasz_ops.dr_step_cuda,
                "lovasz_min_cone": lovasz_ops.min_cone_cuda,
                "lovasz_jacobi_eigh": lovasz_ops.jacobi_eigh_cuda,
                "csvc_smo": csvc_ops.smo_cuda,
                "csvc_vote": csvc_ops.vote_cuda,
                "gram_normalize": gram_ops.normalize_gram_cuda}

    k3_routes = fw_ops.floyd_warshall_cuda.route_launches
    k5_routes = intersect.jaccard_fold_cuda.route_launches
    k8_routes = rw_ops.pair_cg_cuda.route_launches

    def run_path(name, fn):
        for c in counters.values():
            c.launches = 0
        for routes in (k3_routes, k5_routes, k8_routes):
            for r in routes:
                routes[r] = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        launches = {k: c.launches for k, c in counters.items()}
        launches["floyd_warshall_by_route"] = dict(k3_routes)
        launches["jaccard_fold_by_route"] = dict(k5_routes)
        launches["rw_cg_by_route"] = dict(k8_routes)
        print("path %s: %.3f s, launches %s" % (name, secs, launches),
              flush=True)
        return out, secs, launches

    paths = {}

    # ---------------- WL-VH h=5, NCI1-scale ---------------------------- #
    train, held = generate_dataset(
        n_graphs=N_GRAPHS + N_HELD, n_graphs_test=N_HELD,
        r_vertices=(10, 50), r_connectivity=(0.07, 0.15),
        random_state=SEED, features=("nl", N_LABELS))
    alone = {"cv": cv_phase, "gram_norm": gram_norm_phase}
    if len(sys.argv) == 3 and sys.argv[1] == "--phase" \
            and sys.argv[2] in alone:
        # one phase alone (cv: K15, K16; gram_norm: K17): its paths,
        # holds, sweeps and kernel rows
        rows = alone[sys.argv[2]](run_path, check, paths, train)
        for row in rows:
            row["launches"] = sum(p["launches"][row["name"]]
                                  for p in paths.values())
            row["ptxas"] = {k: v for k, v in ptxas_info(nvcc_out).items()
                            if row["name"] in k}
        print(json.dumps({"paths": paths}), flush=True)
        print(json.dumps({"kernels": rows}), flush=True)
        print("chip_smoke: %.1f s in all, the build included"
              % (time.perf_counter() - t_start), flush=True)
        print("nvidia-smi: %s" % smi, flush=True)
        if check.failed:
            print("chip_smoke: %d check(s) failed: %s"
                  % (len(check.failed), "; ".join(check.failed)),
                  file=sys.stderr)
            return 1
        print(json.dumps({"ok": True, "phase": sys.argv[2]}))
        return 0

    def wl_path():
        wl = WeisfeilerLehman(n_iter=5, normalize=False)
        t = time.perf_counter()
        K = wl.fit_transform(train)
        t_fit = time.perf_counter() - t
        d = wl.diagonal()
        t = time.perf_counter()
        Kt = wl.transform(held)
        return K, d, Kt, t_fit, time.perf_counter() - t

    (K, d, Kt, t_fit, t_tr), secs, launches = run_path("wl_vh", wl_path)
    paths["wl_vh_h5_nci1scale"] = {"graphs": N_GRAPHS, "held_out": N_HELD,
                                   "wall_s": secs,
                                   "fit_transform_s_first": t_fit,
                                   "transform_s": t_tr,
                                   "launches": launches}
    check(launches["wl_hash_refine"] > 0, "WL-VH launched K2 (%d)"
          % launches["wl_hash_refine"])
    check(K.shape == (N_GRAPHS, N_GRAPHS) and np.isfinite(K).all()
          and Kt.shape == (N_HELD, N_GRAPHS) and np.isfinite(Kt).all(),
          "WL-VH Grams finite, shapes %s %s" % (K.shape, Kt.shape))
    check(np.array_equal(np.diagonal(K), d), "WL-VH diag(K) == diagonal()")

    def wl_fit():
        return WeisfeilerLehman(n_iter=5, normalize=False).fit_transform(
            train)

    paths["wl_vh_h5_nci1scale"].update(warm_runs(wl_fit, 2))
    check(np.array_equal(K, wl_fit()), "WL-VH repeat run identical")
    with use_device("cpu"):
        wl_c = WeisfeilerLehman(n_iter=5, normalize=False)
        t = time.perf_counter()
        Kc = wl_c.fit_transform(train)
        Ktc = wl_c.transform(held)
        paths["wl_vh_h5_nci1scale"]["cpu_s"] = time.perf_counter() - t
    check(np.array_equal(K, Kc) and np.array_equal(Kt, Ktc),
          "WL-VH Grams == use_device('cpu') Grams")
    del Kc, Ktc

    # ---------------- PM unlabeled, REDDIT-B-scale ---------------------- #
    coo = heavy_tailed_graphs(seed=SEED, **REDDIT_B)

    def reddit():
        # fresh Graph objects: PyramidMatch caches embeddings in them
        return [Graph.from_arrays(n, s, r) for n, s, r in coo]

    def pm_run(graphs, **kw):
        pm = PyramidMatch(L=4, d=6, **kw)
        return pm, pm.fit_transform(graphs())

    pm_mats = {}   # each PM path's level matrices, on the card
    pm_fit = {}    # each PM path's fitted kernel and Gram
    for key, name, graphs, kw in (
            ("pm_unlabeled_redditb", "pm_unlabeled", reddit,
             {"with_labels": False}),
            ("pm_labeled_nci1scale", "pm_labeled", lambda: train,
             {"with_labels": True})):
        (pm, Kp), secs, launches = run_path(
            name, lambda g=graphs, k=kw: pm_run(g, **k))
        n = len(graphs())
        paths[key] = {"graphs": n, "wall_s": secs, "launches": launches,
                      "stages_s": dict(pm.timer_.times)}
        Kref, mats = level_grams(pm, intersect.min_gram_plain)
        # fit_transform's level routes: the levels that take K1 go in one
        # K1 call, the other levels (weights up to 127) in ONE K1-tc call,
        # its expansion one launch (weighted and 0/1 indicators together)
        maxima = [M.amax(0).cpu().numpy() for M in mats]
        routes = [intersect.min_gram_route(mx, mx, True, True)
                  for mx in maxima]
        paths[key]["level_routes"] = routes
        tc_levels = int("min_gram_tc" in routes)
        want = {"min_gram": int("min_gram" in routes),
                "min_gram_tc": tc_levels, "threshold_expand": tc_levels}
        check(all(launches[k] == v for k, v in want.items()),
              "%s launched K1 %d, K1-tc %d and the expansion %d times, as "
              "its level routes %s name (%s)"
              % (name, launches["min_gram"], launches["min_gram_tc"],
                 launches["threshold_expand"], routes, want))
        if kw["with_labels"]:
            check(launches["min_gram_tc"] == 1,
                  "%s launched K1-tc exactly once for its Gram" % name)
        else:
            check(launches["min_gram"] == 1 and launches["min_gram_tc"] == 0,
                  "%s launched K1 exactly once for its Gram" % name)
        check(Kp.shape == (n, n) and np.isfinite(Kp).all()
              and np.array_equal(Kp, Kref),
              "%s Gram == plain level Grams combined" % name)
        paths[key].update(warm_runs(lambda g=graphs, k=kw: pm_run(g, **k),
                                    0))
        pm_mats[name] = mats
        pm_fit[name] = (pm, Kp)
    paths["pm_unlabeled_redditb"]["max_vertices"] = int(max(
        n for n, _, _ in coo))

    # the unlabeled PM Gram stage from the uploaded levels to the f64
    # Gram: one K1 call over the weighted, concatenated levels (the path)
    # against one K1 call and a torch fold a level (the path before the
    # levels were fused), both on the current K1
    pm_u, Kp_u = pm_fit["pm_unlabeled"]
    scale = float(2 ** max(pm_u.L - 1, 0))
    weights = [float(round(c * scale)) for c in pm_u._level_coeffs()]
    fused_W = torch.cat([w * M for w, M in zip(weights,
                                               pm_mats["pm_unlabeled"])],
                        1).contiguous()

    def stage_fused():
        return intersect.min_gram_cuda(fused_W, fused_W).double() / scale

    def stage_levels():
        K = None
        for w, M in zip(weights, pm_mats["pm_unlabeled"]):
            Kj = intersect.min_gram_cuda(M, M)
            K = Kj.mul_(w) if K is None else K.add_(Kj, alpha=w)
        return K.double() / scale

    def stage_row(fn):
        reps = 10
        _, busy, by_name, counts = profiled(
            lambda: [fn() for _ in range(reps)])
        k1_ms = sum(v for k, v in by_name.items() if "min_gram_kernel" in k)
        k1_n = sum(v for k, v in counts.items() if "min_gram_kernel" in k)
        # None where the profiler kept no CUDA record of the session
        per = lambda v: None if busy is None else v / reps
        return {"ms": cuda_ms(fn, 50), "profiled_device_ms": per(busy),
                "k1_device_ms": per(k1_ms),
                "other_device_ms": per((busy or 0.0) - k1_ms),
                "k1_launches": k1_n / reps,
                "device_activities": {k[:60]: v / reps
                                      for k, v in by_name.items()}}

    gram_stage = {"fused": stage_row(stage_fused),
                  "per_level": stage_row(stage_levels)}
    check(np.array_equal(stage_fused().cpu().numpy(), Kp_u)
          and np.array_equal(stage_levels().cpu().numpy(), Kp_u),
          "PM unlabeled Gram stage, fused and per level, == the path's Gram")
    paths["pm_unlabeled_redditb"]["gram_stage"] = gram_stage
    print("PM unlabeled Gram stage (profiled ms): fused %s (K1 %s), per "
          "level %s (K1 %s)" % tuple(
              "not measured" if v is None else "%.4f" % v
              for v in (gram_stage["fused"]["profiled_device_ms"],
                        gram_stage["fused"]["k1_device_ms"],
                        gram_stage["per_level"]["profiled_device_ms"],
                        gram_stage["per_level"]["k1_device_ms"])),
          flush=True)
    # ---------------- ShortestPath: the slice of K3 --------------------- #
    # sparse_counts_gram (WL-SP's late generations) timed where it runs
    sparse_s = []
    plain_sparse = sp_mod.sparse_counts_gram

    def timed_sparse(*a, **k):
        t = time.perf_counter()
        out = plain_sparse(*a, **k)
        sparse_s.append(time.perf_counter() - t)
        return out

    sp_mod.sparse_counts_gram = timed_sparse

    def sp_run(spec, fit, tr, dev=None):
        """GraphKernel(kernel=spec): fit_transform on ``fit``, transform
        of ``tr``, both diagonals; on ``dev`` (None: the card)."""
        gk = GraphKernel(kernel=spec)
        with use_device(dev):
            t = time.perf_counter()
            K = gk.fit_transform(fit)
            t_fit = time.perf_counter() - t
            d = gk.diagonal()
            t = time.perf_counter()
            Kt = gk.transform(tr)
            t_tr = time.perf_counter() - t
            xd, yd = gk.diagonal()
        return {"out": (K, d, Kt, xd, yd), "fit_transform_s": t_fit,
                "transform_s": t_tr, "gk": gk}

    def sp_path(key, spec, fit, tr, **info):
        """Run ``spec`` on the card (a path: counts read around it) and
        on the CPU; check K3 launched, finite Grams of the right shapes,
        diag(K) == diagonal(), and every output equal to the CPU's."""
        del sparse_s[:]
        r, secs, launches = run_path(key, lambda: sp_run(spec, fit, tr))
        K, d, Kt = r["out"][:3]
        paths[key] = dict(info, graphs=len(fit), held_out=len(tr),
                          wall_s=secs,
                          fit_transform_s_first=r["fit_transform_s"],
                          transform_s=r["transform_s"], launches=launches,
                          sparse_counts_gram_calls=len(sparse_s),
                          sparse_counts_gram_s=sum(sparse_s))
        check(launches["floyd_warshall"] > 0, "%s launched K3 (%d)"
              % (key, launches["floyd_warshall"]))
        check(K.shape == (len(fit), len(fit)) and np.isfinite(K).all()
              and Kt.shape == (len(tr), len(fit)) and np.isfinite(Kt).all(),
              "%s Grams finite, shapes %s %s" % (key, K.shape, Kt.shape))
        check(np.array_equal(np.diagonal(K), d),
              "%s diag(K) == diagonal()" % key)
        t = time.perf_counter()
        c = sp_run(spec, fit, tr, "cpu")
        paths[key]["cpu_s"] = time.perf_counter() - t
        check(all(np.array_equal(np.asarray(a), np.asarray(b))
                  for a, b in zip(r["out"], c["out"])),
              "%s Grams and diagonals == use_device('cpu') ones" % key)
        return r["gk"]

    # the slice's main path, at full size: the direct-index route
    sp = sp_path("sp_nci1scale", "shortest_path", train, held)
    spk = sp.kernel_
    paths["sp_nci1scale"].update(
        route=spk._plan(spk.X)[0], stages_s=dict(spk.timer_.times),
        buckets={int(b[1].shape[1]): len(b[0]) for b in spk.X["buckets"]})

    def sp_fit():
        gk = GraphKernel(kernel="shortest_path")
        gk.fit_transform(train)
        return gk.transform(held)

    paths["sp_nci1scale"].update(warm_runs(sp_fit, 3))

    # weighted graphs: the hash route (f32 distance bits as keys)
    wtrain, wheld = generate_dataset(
        n_graphs=1024 + N_HELD, n_graphs_test=N_HELD, r_vertices=(10, 50),
        r_connectivity=(0.07, 0.15), r_weight_edges=(0.5, 2.0),
        random_state=SEED, features=("nl", N_LABELS))
    wsp = sp_path("sp_weighted", "shortest_path", wtrain, wheld).kernel_
    paths["sp_weighted"]["route"] = wsp._plan(wsp.X)[0]
    check(paths["sp_weighted"]["route"] == "hash",
          "weighted SP took the hash route")
    sp_path("wl_sp_h5", [{"name": "WL", "n_iter": 5}, "shortest_path"],
            train, held)
    sp_path("core_sp", [{"name": "core_framework"}, "shortest_path"],
            train, held)
    mutag = read_data("MUTAG", path=os.path.join(HERE, "tests", "data")).data
    for key, spec in (("sp_mutag", "shortest_path"),
                      ("core_sp_mutag", [{"name": "core_framework"},
                                         "shortest_path"])):
        sp_path(key, spec, mutag[:150], mutag[150:],
                data="MUTAG via read_data, fit 150, transform 38")
    # unlabeled SP on REDDIT-B-scale graphs: unit weights past V = 128,
    # K3's blocked route.  Cut to the stand-in's graphs of 129-512
    # vertices, the first 96 to fit and the next 16 to transform, so the
    # CPU run's plain Floyd-Warshall stays well under a minute.
    mid = [g for g in coo if 129 <= g[0] <= 512]
    rb_fit = [Graph.from_arrays(n, s, r) for n, s, r in mid[:96]]
    rb_tr = [Graph.from_arrays(n, s, r) for n, s, r in mid[96:112]]
    rbk = sp_path("sp_redditb_unlabeled",
                  {"name": "shortest_path", "with_labels": False},
                  rb_fit, rb_tr,
                  data="REDDIT-B-scale stand-in (seed 1234): its graphs "
                       "of 129-512 vertices, fit the first 96, transform "
                       "the next 16",
                  cut="graphs outside 129-512 vertices and past the "
                      "first 112 of them left out").kernel_
    rb = paths["sp_redditb_unlabeled"]
    rb.update(route=rbk._plan(rbk.X)[0], stages_s=dict(rbk.timer_.times),
              buckets={int(b[1].shape[1]): len(b[0])
                       for b in rbk.X["buckets"]})

    def rb_run():
        gk = GraphKernel(kernel={"name": "shortest_path",
                                 "with_labels": False})
        gk.fit_transform(rb_fit)
        return gk.transform(rb_tr)

    rb.update(warm_runs(rb_run, 3))
    by_route = rb["launches"]["floyd_warshall_by_route"]
    check(by_route["blocked"] == rb["launches"]["floyd_warshall"] > 0,
          "sp_redditb_unlabeled took K3's blocked route on every call %s"
          % by_route)
    sp_mod.sparse_counts_gram = plain_sparse

    # ---------------- ShortestPath's stream mode ------------------------ #
    t = time.perf_counter()
    slab_k, top_graphs = sp_stream_phase(run_path, check, paths)
    print("chip_smoke: the stream phase took %.1f s"
          % (time.perf_counter() - t), flush=True)

    # ---------------- NeighborhoodHash and WL-OA: K4 and K5 ------------- #
    def w_ratio(ma, mb):
        return float(np.minimum(ma, mb).sum()) / ma.size

    def nh_run(params, dev=None):
        """GraphKernel(kernel="NH", random_state=0): fit_transform on the
        NCI1-scale set, transform of the held-out graphs; on ``dev``
        (None: the card)."""
        gk = GraphKernel(kernel=dict(params, name="NH"), random_state=0)
        with use_device(dev):
            t = time.perf_counter()
            K = gk.fit_transform(train)
            t_fit = time.perf_counter() - t
            d = gk.diagonal()
            t = time.perf_counter()
            Kt = gk.transform(held)
            t_tr = time.perf_counter() - t
        return {"out": (K, Kt), "diag": d, "fit_transform_s": t_fit,
                "transform_s": t_tr, "gk": gk}

    nh_kernels, paths_out = {}, {}
    for key, params in (("nh_nci1scale", {}),
                        ("nh_cs_nci1scale", {"nh_type": "count_sensitive"})):
        r, secs, launches = run_path(key, lambda p=params: nh_run(p))
        k = r["gk"].kernel_
        nh_kernels[key] = k
        paths_out[key] = r["out"]
        K, Kt = r["out"]
        X, Y = k.X["hists"], k._Y["hists"]
        rounds = []
        for q in range(k.R):
            mx = X[q].amax(0).cpu().numpy()
            my = Y[q].amax(0).cpu().numpy()
            rounds.append({
                "round": q, "fit_route": intersect.min_gram_route(
                    mx, mx, True, True), "fit_w_ratio": w_ratio(mx, mx),
                "transform_route": intersect.min_gram_route(
                    my, mx, True, False),
                "transform_w_ratio": w_ratio(my, mx),
                "max_count": float(max(mx.max(), my.max()))})
        print("%s rounds (route, W'/L): %s" % (key, "; ".join(
            "r%d fit %s %.3f, transform %s %.3f" % (
                q["round"], q["fit_route"], q["fit_w_ratio"],
                q["transform_route"], q["transform_w_ratio"])
            for q in rounds)), flush=True)
        # the rounds that take K1-tc: ONE K1-tc launch a Gram (fit,
        # transform), one expansion launch a side
        tc_fit = any(q["fit_route"] == "min_gram_tc" for q in rounds)
        tc_tr = any(q["transform_route"] == "min_gram_tc" for q in rounds)
        k1_rounds = sum((q["fit_route"] == "min_gram")
                        + (q["transform_route"] == "min_gram")
                        for q in rounds)
        want = {"min_gram_tc": tc_fit + tc_tr, "min_gram": k1_rounds,
                "threshold_expand": tc_fit + 2 * tc_tr}
        folds = launches["jaccard_fold_by_route"]
        check(launches["nh_graph"] == 2 and launches["nh_round"] == 0
              and launches["jaccard_fold"] == 2
              and folds["triangle"] == folds["rect"] == 1
              and all(launches[c] == v for c, v in want.items()),
              "%s launched K4 %d times on the graph route (one a parse, 2 "
              "parses) and %d on the round route, K5 %d (one a Gram: %s), "
              "K1-tc %d, the expansion %d and K1 %d (as the rounds' routes "
              "name: %s)"
              % (key, launches["nh_graph"], launches["nh_round"],
                 launches["jaccard_fold"], folds, launches["min_gram_tc"],
                 launches["threshold_expand"], launches["min_gram"], want))
        check(launches["min_gram_tc"] == 2,
              "%s launched K1-tc once a rounds call (%d in 2 calls)"
              % (key, launches["min_gram_tc"]))
        check(K.shape == (N_GRAPHS, N_GRAPHS) and Kt.shape == (N_HELD,
                                                                N_GRAPHS)
              and np.isfinite(K).all() and np.isfinite(Kt).all()
              and 0 <= K.min() and K.max() <= 1 and 0 <= Kt.min()
              and Kt.max() <= 1 and r["diag"] == 1.0,
              "%s Grams finite in [0, 1], shapes %s %s, diagonal() 1"
              % (key, K.shape, Kt.shape))
        t = time.perf_counter()
        c = nh_run(params, "cpu")
        cpu_s = time.perf_counter() - t
        check(all(np.array_equal(a, b) for a, b in zip(r["out"], c["out"])),
              "%s Grams == use_device('cpu') Grams bit for bit" % key)
        paths[key] = dict(
            graphs=N_GRAPHS, held_out=N_HELD, R=k.R, bits=k.bits,
            nh_type=k.nh_type, wall_s=secs,
            fit_transform_s_first=r["fit_transform_s"],
            transform_s=r["transform_s"], launches=launches, rounds=rounds,
            stages_s=dict(k.timer_.times), cpu_s=cpu_s)
        paths[key].update(warm_runs(lambda p=params: nh_run(p), 3))

    def wloa_run(dev=None):
        k = WeisfeilerLehmanOptimalAssignment(n_iter=5)
        with use_device(dev):
            t = time.perf_counter()
            K = k.fit_transform(train)
            t_fit = time.perf_counter() - t
            d = k.diagonal()
            t = time.perf_counter()
            Kt = k.transform(held)
            t_tr = time.perf_counter() - t
            xd, yd = k.diagonal()
        return {"out": (K, d, Kt, xd, yd), "fit_transform_s": t_fit,
                "transform_s": t_tr, "k": k}

    r, secs, launches = run_path("wloa_nci1scale", wloa_run)
    K, d, Kt = r["out"][:3]
    check(K.shape == (N_GRAPHS, N_GRAPHS) and np.isfinite(K).all()
          and Kt.shape == (N_HELD, N_GRAPHS) and np.isfinite(Kt).all()
          and np.array_equal(np.diagonal(K), d),
          "wloa_nci1scale Grams finite, shapes %s %s, diag(K) == diagonal()"
          % (K.shape, Kt.shape))
    t = time.perf_counter()
    c = wloa_run("cpu")
    cpu_s = time.perf_counter() - t
    check(all(np.array_equal(a, b) for a, b in zip(r["out"], c["out"])),
          "wloa_nci1scale Grams and diagonals == use_device('cpu') ones")
    wx = r["k"].X
    paths["wloa_nci1scale"] = dict(
        graphs=N_GRAPHS, held_out=N_HELD, n_iter=5, wall_s=secs,
        fit_transform_s_first=r["fit_transform_s"],
        transform_s=r["transform_s"], launches=launches, cpu_s=cpu_s,
        expanded_columns=int(wx["width"]),
        repeated_columns=int((np.bincount(wx["eids"]) > 1).sum()),
        gram_dtype=str(K.dtype))
    paths["wloa_nci1scale"].update(warm_runs(wloa_run, 0))

    # ---------------- HadamardCode and Propagation: K6 ------------------ #
    k6_count = hc_ops.hadamard_step_cuda

    def k6_routes():
        return hc_ops.hadamard_graph_cuda.launches, k6_count.launches

    def class_run(make, fit, tr, dev=None):
        """``make()``'s kernel: fit_transform on ``fit``, diagonal(),
        transform of ``tr``, both diagonals, on ``dev`` (None: the card);
        with K6's launches (graph route, round route) in fit_transform
        and in transform."""
        k = make()
        with use_device(dev):
            n0 = k6_routes()
            t = time.perf_counter()
            K = k.fit_transform(fit)
            t_fit = time.perf_counter() - t
            n1 = k6_routes()
            d = k.diagonal()
            t = time.perf_counter()
            Kt = k.transform(tr)
            t_tr = time.perf_counter() - t
            n2 = k6_routes()
            xd, yd = k.diagonal()
        return {"out": (K, d, Kt, xd, yd), "fit_transform_s": t_fit,
                "transform_s": t_tr, "k": k,
                "k6": tuple(tuple(b - a for a, b in zip(x, y))
                            for x, y in ((n0, n1), (n1, n2)))}

    def class_path(key, make, fit, tr, k6, warm, rtol=None, compare_on=None,
                   **info):
        """Drive ``make()``'s kernel on the card (a path: counts read
        around it) and on the CPU: finite Grams of the right shapes,
        diag(K) == diagonal(), K6's graph route launched ``k6`` times in
        fit_transform and ``k6`` in transform and its round route never,
        every output equal to the CPU run's bit for bit (to ``rtol``
        when given: f64 products summed in another order, or f32
        solvers); ``compare_on`` = (fit', tr') holds a card run on those
        against the CPU instead (a cut where the CPU run is slow); then
        ``warm`` warm runs and a profiled one (none when ``warm`` is
        None)."""
        r, secs, launches = run_path(key, lambda: class_run(make, fit, tr))
        K, d, Kt = r["out"][:3]
        check(K.shape == (len(fit), len(fit)) and np.isfinite(K).all()
              and Kt.shape == (len(tr), len(fit)) and np.isfinite(Kt).all()
              and np.array_equal(np.diagonal(K),
                                 np.broadcast_to(d, (len(fit),))),
              "%s Grams finite, shapes %s %s, diag(K) == diagonal()"
              % (key, K.shape, Kt.shape))
        check(r["k6"] == ((k6, 0), (k6, 0)), "%s launched K6 (graph "
              "route, round route) %s times in fit_transform and transform "
              "((%d, 0) each wanted)" % (key, r["k6"], k6))
        t = time.perf_counter()
        if compare_on is None:
            card = r["out"]
            c = class_run(make, fit, tr, "cpu")
        else:
            card = class_run(make, *compare_on)["out"]
            c = class_run(make, *compare_on, "cpu")
        cpu_s = time.perf_counter() - t
        if rtol is None:
            check(all(np.array_equal(a, b)
                      for a, b in zip(card, c["out"])),
                  "%s Grams and diagonals == use_device('cpu') ones bit "
                  "for bit" % key)
        else:
            err = max(float(np.max(np.abs(np.asarray(a, np.float64) - b)
                                   / np.maximum(np.abs(b), 1e-300),
                                   initial=0.0))
                      for a, b in zip(card, c["out"]))
            check(all(np.allclose(a, b, rtol=rtol, atol=0)
                      for a, b in zip(card, c["out"])),
                  "%s Grams and diagonals == use_device('cpu') ones to "
                  "rtol %g (largest relative difference %.3g)"
                  % (key, rtol, err))
            info = dict(info, cpu_max_rel_diff=err)
        timer = getattr(r["k"], "timer_", None)
        paths[key] = dict(
            info, graphs=len(fit), held_out=len(tr), wall_s=secs,
            fit_transform_s_first=r["fit_transform_s"],
            transform_s=r["transform_s"], launches=launches,
            k6_launches_per_call=r["k6"], gram_dtype=str(K.dtype),
            stages_s=None if timer is None else dict(timer.times),
            cpu_s=cpu_s)
        if warm is not None:
            paths[key].update(warm_runs(lambda: class_run(make, fit, tr),
                                        warm))
        return r["k"]

    hck = class_path("hc_nci1scale", lambda: HadamardCode(n_iter=5), train,
                     held, 1, 1, n_iter=5, base="VertexHistogram (fast "
                     "path)", dimension=HadamardCode._hdim(N_LABELS))
    class_path("hc_sp_mutag", lambda: HadamardCode(
        n_iter=5, base_graph_kernel=(ShortestPath, {})), mutag[:150],
        mutag[150:], 0, 1, n_iter=5, base="ShortestPath (host path)",
        data="MUTAG via read_data, fit 150, transform 38")
    check(paths["hc_sp_mutag"]["launches"]["floyd_warshall"] > 0,
          "hc_sp_mutag launched K3 (%d)"
          % paths["hc_sp_mutag"]["launches"]["floyd_warshall"])
    pk = class_path("prop_nci1scale", lambda: Propagation(random_state=0),
                    train, held, 0, 1, M="TV", t_max=5, w=0.01)
    unseen = sum(isinstance(b, Counter) for phi in pk._Y for b in
                 phi.values())
    check(unseen > 0, "prop_nci1scale's transform ran the unseen-label "
          "branch (%d bags of it)" % unseen)
    paths["prop_nci1scale"]["unseen_branch_bags"] = unseen
    cun = read_data("Cuneiform", path=os.path.join(HERE, "tests", "data"),
                    prefer_attr_nodes=True).data
    class_path("propattr_cuneiform", lambda: PropagationAttr(random_state=0),
               cun[:200], cun[200:], 0, 3, M="L1", t_max=5, w=4,
               data="Cuneiform via read_data (real attributes), fit 200, "
                    "transform %d" % (len(cun) - 200))
    native_phase(class_path, check, paths, train, held, mutag)
    k789 = slice_gs_rw_phase(class_path, check, paths, train, held, mutag)
    print("chip_smoke: %.1f s before the theta phase"
          % (time.perf_counter() - t_start), flush=True)
    k1013 = slice_theta_phase(class_path, check, paths, train, held, cun)
    print("chip_smoke: %.1f s after it" % (time.perf_counter() - t_start),
          flush=True)
    k2r = parallel_phase(run_path, check, paths, train, held)
    print("chip_smoke: %.1f s after the parallel phase"
          % (time.perf_counter() - t_start), flush=True)
    k1516 = cv_phase(run_path, check, paths, train)
    print("chip_smoke: %.1f s after the cross-validation phase"
          % (time.perf_counter() - t_start), flush=True)
    k17 = gram_norm_phase(run_path, check, paths, train)
    print(json.dumps({"paths": paths}), flush=True)

    # ---------------- K1 against its plain version ---------------------- #
    def k1_case(A, B, integer, sweep=False, out=None, alpha=1.0):
        """K1 on A, B (the block triangle when B is A; into ``out`` with
        ``alpha`` when given) against the plain version, timed beside its
        bound, the plain version and cdist; ``sweep`` times every tile
        instantiation too, each checked against the plain version."""
        sym = B is A
        n, L = A.shape
        m = B.shape[0]
        R = intersect.min_gram_plain(A, B)
        base = None if out is None else out.clone()
        K = intersect.min_gram_cuda(A, B, out, alpha)
        torch.cuda.synchronize()
        want = R if out is None else base + alpha * R
        err = float((K - want).abs().max()) if K.numel() else 0.0
        ok = torch.equal(K, want) if integer else torch.allclose(
            K, want, rtol=1e-5, atol=1e-4)
        check(ok, "K1 %dx%dx%d %s %s%s vs plain, max abs err %g"
              % (n, m, L, "symmetric" if sym else "rect",
                 "integer" if integer else "real",
                 "" if out is None else ", K += %g Gram" % alpha, err))
        big = n * m * L > 1e9
        # the function's own work: 2 L operations a distinct entry (n (n +
        # 1) / 2 of them when symmetric); the inputs read once, the output
        # written once and read once more when accumulating
        ops = 2.0 * L * (n * (n + 1) / 2 if sym else n * m)
        nbytes = 4.0 * ((n if sym else n + m) * L
                        + n * m * (1 if out is None else 2))
        t_ops, t_bytes = ops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S

        def call():
            return intersect.min_gram_cuda(A, B, out, alpha)

        row = {"n": n, "m": m, "L": L, "symmetric": sym,
               "tile": intersect.K1_TILES[intersect.k1_tile(n, m, sym)],
               "accumulate": out is not None, "max_abs_err": err,
               "ops": ops, "bytes": nbytes,
               "ms": cuda_ms(call, 5 if big else 50),
               "device_ms": device_ms(call, 5 if big else 20,
                                      "min_gram_kernel"),
               "wrapper_ms": host_ms(call, 5 if big else 20),
               "plain_ms": cuda_ms(lambda: intersect.min_gram_plain(A, B),
                                   1 if big else 5),
               "library_ms": cuda_ms(lambda: torch.cdist(A, B, p=1),
                                     3 if big else 20),
               "bound_ms": 1e3 * max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        if sweep:
            row["tile_sweep"] = []
            for tile, shape in sorted(intersect.K1_TILES.items()):
                def tcall(tile=tile):
                    return intersect.min_gram_cuda(A, B, tile=tile)
                row["tile_sweep"].append({
                    "tile": shape, "bit_identical": torch.equal(tcall(), R),
                    "ms": cuda_ms(tcall, 5 if big else 50)})
            check(all(t["bit_identical"] for t in row["tile_sweep"]),
                  "K1 %dx%dx%d bit-identical at every tile" % (n, m, L))
        return row

    # the call the unlabeled PM path makes, then each of its levels alone
    k1 = [k1_case(fused_W, fused_W, True, sweep=True)]
    k1_levels = [k1_case(A, A, True) for A in pm_mats["pm_unlabeled"]]
    k1_labeled = [k1_case(A, A, True, sweep=True)
                  for A in pm_mats["pm_labeled"]]
    # PyramidMatch's transform shape at the labeled levels: a 10-fold
    # cross-validation split of the NCI1-scale set, the 411 test graphs'
    # rows against the 3699 training graphs'
    n_test = N_GRAPHS // 10
    rect = [(A[N_GRAPHS - n_test:].clone(), A[:N_GRAPHS - n_test].clone())
            for A in pm_mats["pm_labeled"]]
    k1_rect = [k1_case(A, B, True, sweep=True) for A, B in rect]
    rng = np.random.RandomState(SEED)
    ragged = k1_case(torch.from_numpy(rng.rand(37, 333).astype(np.float32))
                     .cuda(),
                     torch.from_numpy(rng.rand(1001, 333).astype(np.float32))
                     .cuda(), False)
    # the triangle against the full rectangle at a ragged n (no multiple
    # of a tile side) and at n = 1, on counts and on reals: the same sums
    # in the same order, so equal bit for bit, and the mirror exactly the
    # transpose
    sym_checks = []
    for n_r, integer in ((1001, True), (1001, False), (1, True)):
        X = rng.randint(0, 9, (n_r, 77)) if integer else rng.rand(n_r, 77)
        X = torch.from_numpy(X.astype(np.float32)).cuda()
        Ks, Kr = intersect.min_gram_cuda(X, X), intersect.min_gram_cuda(
            X, X.clone())
        same = torch.equal(Ks, Kr) and torch.equal(Ks, Ks.T)
        sym_checks.append({"n": n_r, "L": 77, "integer": integer,
                           "triangle_equals_rect_and_transpose": same})
        check(same, "K1 %dx%dx77 %s: triangle == rectangle, K == K.T"
              % (n_r, n_r, "integer" if integer else "real"))
    # the alpha / accumulate epilogue at the path's call
    acc_case = k1_case(fused_W, fused_W, True,
                       out=torch.full((fused_W.shape[0],) * 2, 5.0,
                                      device="cuda"), alpha=3.0)

    # ---------------- K1-tc against its plain version ------------------- #
    def old_expand(X, cols):
        """The earlier expansion: an f32 gather of the source columns, compared
        into int8 by torch (the [n, W'] f32 intermediate included)."""
        return (X.index_select(1, cols[0]) >= cols[1]).view(torch.int8)

    def tc_bound(R, n, m, W, Wp, sym, in_bytes):
        """The function's own work: 2 W' operations a distinct Gram entry
        (n (n + 1) / 2 of them when symmetric) a round; the indicators
        read once and the f32 Gram stack written once."""
        ops = 2.0 * W * (n * (n + 1) / 2 if sym else n * m)
        return ops, in_bytes + 4.0 * R * n * m

    def tc_case(A, B, weights=None, reps=20, sweep=False, mma=False):
        """K1-tc as the entry points call it: A, B [n, L] or [R, n, L]
        counts (B is A: symmetric), ``weights`` on A's indicators; the
        expansion (one launch a side, one for both when symmetric and
        weighted) and ONE product launch, against the plain version
        exactly (and the alpha / out epilogue), timed beside the plain
        version, ``torch._int_mm`` on the same indicators (one call a
        round, the full square), the bound and, with ``mma``, the earlier
        design on the same inputs (its torch expansion and its mma.sync
        kernel, one call a round)."""
        sym = B is A
        A3 = A if A.dim() == 3 else A[None]
        B3 = A3 if sym else (B if B.dim() == 3 else B[None])
        R, n, L = A3.shape
        m = B3.shape[1]
        max_a, max_b, integer = intersect._round_stats(A3, B3)
        T = np.minimum(max_a, max_b)
        routes = [intersect.min_gram_route(max_a[r], max_b[r], integer[r],
                                           sym) for r in range(R)]
        cols = torch.from_numpy(intersect.threshold_columns(
            T if A.dim() == 3 else T[0], weights)).cuda()

        def expand():
            if weights is None:
                EA = intersect.expand_thresholds(A, cols)
                return EA, (EA if sym else intersect.expand_thresholds(
                    B, cols))
            if sym:
                return intersect.expand_thresholds(A, cols, indicators=True)
            return (intersect.expand_thresholds(A, cols),
                    intersect.expand_thresholds(B, cols, weighted=False))

        n_exp = intersect.threshold_expand_cuda.launches
        EA, EB = expand()
        n_exp = intersect.threshold_expand_cuda.launches - n_exp
        W = int(T.sum(1).max())
        Wp = int(EA.shape[-1])

        def call():
            return intersect.min_gram_tc_cuda(EA, EB, symmetric=sym)

        def whole():
            return intersect.min_gram_tc_cuda(*expand(), symmetric=sym)

        n_tc = intersect.min_gram_tc_cuda.launches
        K = call()
        n_tc = intersect.min_gram_tc_cuda.launches - n_tc
        P = intersect.min_gram_threshold_plain(A, A if sym else B, weights)
        out = K.clone()
        intersect.min_gram_tc_cuda(EA, EB, out=out, alpha=3.0,
                                   symmetric=sym)
        pa, pb = (intersect.expand_thresholds_plain(A, cols, indicators=True)
                  if weights is not None and sym else
                  (intersect.expand_thresholds_plain(A, cols),
                   intersect.expand_thresholds_plain(
                       A if sym else B, cols, weighted=False)))
        torch.cuda.synchronize()
        err = float((K - P).abs().max()) if K.numel() else 0.0
        differing = int((EA != pa).sum() + (EB != pb).sum())
        what = "%s%s %s W' %d (padded %d)%s" % (
            "%d x " % R if A.dim() == 3 else "", n, "x %d" % m, W, Wp,
            ", weighted" if weights is not None else "")
        check(torch.equal(K, P) and torch.equal(out, K + 3.0 * P)
              and differing == 0 and n_tc == 1,
              "K1-tc %s, %s, one launch (%d), expansion %d launch(es) == "
              "plain bit for bit (%d differing bytes); product == plain, K "
              "+= 3 I too; max abs err %g"
              % (what, "symmetric" if sym else "rect", n_tc, n_exp,
                 differing, err))
        # torch._int_mm wants the second operand's columns a multiple of
        # 8; it computes the full square, one call a round
        E2 = EB if EB.dim() == 3 else EB[None]
        E1 = EA if EA.dim() == 3 else EA[None]
        EBp = torch.zeros((R, -(-m // 8) * 8, Wp), dtype=torch.int8,
                          device="cuda")
        EBp[:, :m] = E2
        in_bytes = float(EA.numel() + (0 if EB is EA else EB.numel()))
        ops, nbytes = tc_bound(R, n, m, float(T.sum()), Wp, sym, in_bytes)
        row = {"R": R, "n": n, "m": m, "L": L, "w_expanded": W,
               "w_expanded_rounds": T.sum(1).astype(int).tolist(),
               "w_padded": Wp, "symmetric": sym,
               "weighted": weights is not None, "routes": routes,
               "tile": intersect.TC_TILES[intersect.tc_tile(R, n, m, sym)],
               "launches": n_tc, "expansion_launches": n_exp,
               "max_abs_err": err, "expansion_differing": differing,
               "ms": cuda_ms(call, reps),
               "device_ms": device_ms(call, reps, "min_gram_tc_kernel"),
               "wrapper_ms": host_ms(call, reps),
               "expansion_ms": cuda_ms(expand, reps),
               "with_expansion_ms": cuda_ms(whole, reps),
               "expansion_plain_ms": cuda_ms(
                   lambda: intersect.expand_thresholds_plain(A, cols), 3),
               "plain_ms": cuda_ms(lambda: intersect.min_gram_threshold_plain(
                   A, A if sym else B, weights), 3),
               "library_ms": cuda_ms(lambda: [torch._int_mm(
                   E1[r], EBp[r].t()) for r in range(R)], reps),
               "ops": ops, "bytes": nbytes,
               **{k: v for k, v in bound(nbytes, ops,
                                         INT8_OPS_PER_S).items()
                  if k in ("bound_ms", "bound_by")},
               "expansion_bytes": 4.0 * A3.numel() + (
                   0 if sym else 4.0 * B3.numel()) + in_bytes}
        row["expansion_bound_ms"] = (row["expansion_bytes"]
                                     / HBM_BYTES_PER_S * 1e3)
        if mma and weights is None:
            c2 = [cols] if A.dim() == 2 else list(cols)

            def mma_expand():
                EA2 = [old_expand(A3[r], c2[r][:2]) for r in range(R)]
                return EA2, (EA2 if sym else [old_expand(B3[r], c2[r][:2])
                                              for r in range(R)])

            EA2, EB2 = mma_expand()

            def mma_call():
                return [intersect.min_gram_tc_mma_cuda(
                    EA2[r], EA2[r] if sym else EB2[r]) for r in range(R)]

            K2 = torch.stack(mma_call())
            torch.cuda.synchronize()
            check(torch.equal(K2, P if P.dim() == 3 else P[None]),
                  "K1-tc's mma.sync design (%d launch(es)) %s == plain"
                  % (R, what))
            row.update(mma_ms=cuda_ms(mma_call, reps),
                       mma_expansion_ms=cuda_ms(mma_expand, reps))
        if sweep:
            row["tile_sweep"] = []
            for tile, shape in sorted(intersect.TC_TILES.items()):
                def tcall(tile=tile):
                    return intersect.min_gram_tc_cuda(EA, EB, symmetric=sym,
                                                      tile=tile)
                row["tile_sweep"].append({
                    "tile": shape, "bit_identical": torch.equal(tcall(), P),
                    "ms": cuda_ms(tcall, reps)})
            check(all(t["bit_identical"] for t in row["tile_sweep"]),
                  "K1-tc %s bit-identical at every tile" % what)
        return row

    # PyramidMatch labeled: each level alone (the earlier one call a level, and
    # the break-even against K1), symmetric as fit_transform and at the
    # transform shape of a 10-fold split
    tc = [tc_case(A, A, mma=True) for A in pm_mats["pm_labeled"]]
    tc_rect = [tc_case(A, B, mma=True) for A, B in rect]
    # ... and the path's call: the K1-tc levels concatenated, each column
    # weighted by its level's integer weight, ONE launch; and the same
    # fused form at the transform shape
    pm_l = pm_fit["pm_labeled"][0]
    l_scale = float(2 ** max(pm_l.L - 1, 0))
    l_wts = [int(round(c * l_scale)) for c in pm_l._level_coeffs()]
    l_routes = paths["pm_labeled_nci1scale"]["level_routes"]
    l_tc = [j for j, r in enumerate(l_routes) if r == "min_gram_tc"]
    pm_cat = torch.cat([pm_mats["pm_labeled"][j] for j in l_tc],
                       1).contiguous()
    pm_w = np.concatenate([np.full(pm_mats["pm_labeled"][j].shape[1],
                                   l_wts[j]) for j in l_tc])
    tc_pm = tc_case(pm_cat, pm_cat, pm_w, reps=10)
    tc_pm_rect = tc_case(pm_cat[N_GRAPHS - n_test:].contiguous(),
                         pm_cat[:N_GRAPHS - n_test].contiguous(), pm_w,
                         reps=10)
    # the per-level count of the fused call's bound: each level's own
    # indicators and Gram (the earlier calls)
    tc_pm["bound_ms_per_level_count"] = sum(
        tc[j]["bound_ms"] for j in range(len(tc)) if j in l_tc)
    tc_pm_rect["bound_ms_per_level_count"] = sum(
        tc_rect[j]["bound_ms"] for j in range(len(tc_rect)) if j in l_tc)
    ia = rng.randint(0, 9, (1000, 333)).astype(np.float32)
    ib = rng.randint(0, 9, (777, 333)).astype(np.float32)
    Ia, Ib = torch.from_numpy(ia).cuda(), torch.from_numpy(ib).cuda()
    w333 = rng.randint(1, 128, 333)
    tc_ragged = tc_case(Ia, Ib, reps=5)
    tc_ragged_w = [tc_case(Ia, Ib, w333, reps=5),
                   tc_case(Ia, Ia, w333, reps=5)]
    # the two routes' break-even W' / L at each labeled level, symmetric
    # (fit_transform) and rectangular (transform): K1's time per original
    # column over K1-tc's (expansion included) per expanded column
    for c, s in zip(tc + tc_rect, k1_labeled + k1_rect):
        c["k1_ms"] = s["ms"]
        c["break_even_ratio"] = (s["ms"] / c["L"]) / (
            c["with_expansion_ms"] / c["w_expanded"])
    be_sym = min(c["break_even_ratio"] for c in tc)
    be_rect = min(c["break_even_ratio"] for c in tc_rect)
    # the code's limits are the floors of these readings taken on an H100
    # (ops/intersect.py); a limit more than 15 % above this run's reading
    # would send levels to the slower kernel
    check(intersect._TC_MAX_RATIO_SYM <= 1.15 * be_sym
          and intersect._TC_MAX_RATIO_RECT <= 1.15 * be_rect,
          "route limits within this run's break-even: symmetric limit %g, "
          "break-even %.2f (labeled levels' W'/L %s route to %s); "
          "rectangular limit %g, break-even %.2f (W'/L %s route to %s)"
          % (intersect._TC_MAX_RATIO_SYM, be_sym,
             [round(c["w_expanded"] / c["L"], 2) for c in tc],
             [c["routes"][0] for c in tc], intersect._TC_MAX_RATIO_RECT,
             be_rect, [round(c["w_expanded"] / c["L"], 2) for c in tc_rect],
             [c["routes"][0] for c in tc_rect]))

    # K1-tc at the NH simple path's calls: its fit Gram's three rounds
    # (symmetric 4110 x 4110 over L = 256) in ONE launch and its
    # transform's (64 x 4110) in one, with a tile sweep at the transform
    # shape and the mma.sync design (one call a round) beside
    nhk = nh_kernels["nh_nci1scale"]
    Xh = nhk.X["hists"].float().contiguous()
    Yh = nhk._Y["hists"].float().contiguous()
    tc_nh = [tc_case(Xh, Xh, mma=True), tc_case(Yh, Xh, sweep=True,
                                                 mma=True)]
    check(all(r == "min_gram_tc" for c in tc_nh for r in c["routes"]),
          "NH's rounds all route to K1-tc (%s)"
          % [c["routes"] for c in tc_nh])
    del Xh, Yh

    # ---------------- K2 against its plain versions --------------------- #
    batch = GraphBatch.from_graphs(normalize_input(train),
                                   node_label_enum={}, device="cuda")
    csr = (batch.csr_offsets, batch.csr_targets)
    labs = batch.node_labels
    k2_err = 0
    for gen in range(3):
        key = wl_ops.wl_hash_refine_cuda(labs, *csr)
        pkey = wl_ops.wl_hash_refine_csr_plain(labs, *csr)
        h = torch.stack(wl_ops.key_hashes(key))
        q = torch.stack(wl_ops.wl_hash_refine_plain(
            labs, batch.senders, batch.receivers, batch.edge_mask))
        torch.cuda.synchronize()
        k2_err = max(k2_err, int((key != pkey).sum() + (h != q).sum()))
        labs = wl_ops.compact_key_ids(key, batch.node_mask)[0]
    check(k2_err == 0, "K2 hashes and keys bit-identical to the plain CSR "
          "and COO versions on generations 0-2 (%d differing)" % k2_err)
    N, E = labs.shape[0], batch.csr_targets.shape[0]

    def k2_call():
        return wl_ops.wl_hash_refine_cuda(labs, *csr)

    # labels, offsets and targets in; the int64 key out
    k2_bytes = 4 * N + 4 * (N + 1) + 4 * E + 8 * N
    k2 = {"nodes": N, "edges": E,
          "device_ms": device_ms(k2_call, 50, "wl_hash_csr"),
          "ms": cuda_ms(k2_call, 200, 5), "wrapper_ms": host_ms(k2_call, 200),
          "plain_ms": cuda_ms(
              lambda: wl_ops.wl_hash_refine_csr_plain(labs, *csr), 20),
          "bound_ms": 1e3 * k2_bytes / HBM_BYTES_PER_S, "bound_by": "bytes"}

    # ---------------- K3 against its plain version ---------------------- #
    def k3_device_ms(fn, reps, V, route):
        """Device ms per call of K3 from torch.profiler's kernel records
        over ``reps`` calls: each kernel's mean record times its launches
        a call (route tile: fw_tile once; per_k: fw_init once and fw_step
        V times; blocked: fw_init once and each phase once a round), and
        the number of records seen (None, 0 when none)."""
        by_name, counts = kernel_records(fn, reps, ("fw_",))
        nt = -(-V // fw_ops.BLOCKED_TILE)
        per_call = {"tile": {"fw_tile": 1},
                    "per_k": {"fw_init": 1, "fw_step": V},
                    "blocked": {"fw_init": 1, "fw_pivot": nt,
                                "fw_panel": nt, "fw_rest": nt}}[route]
        ms, seen = 0.0, 0
        for k, t in by_name.items():
            for f, times in per_call.items():
                if f in k:
                    ms += t / counts[k] * times
                    seen += counts[k]
        return (ms if seen else None), seen

    def k3_case(A, M, what, integral=False, reps=50, profile=True):
        n, V = A.shape[:2]
        route = fw_ops.fw_route(V, integral)
        smem = 0   # dynamic shared memory a block (ptxas shows static)
        if route == "tile":
            T, G = fw_ops.fw_tile_config(n, V)
            inst = "T=%d, G=%d" % (T, G)
            smem = 16 * G * -(-V // T) * T
        elif route == "blocked":
            inst = "%d-wide tiles, %d launches" % (
                fw_ops.BLOCKED_TILE, 1 + 3 * -(-V // fw_ops.BLOCKED_TILE))
        else:
            inst = "%d launches" % (V + 1)
        S = fw_ops.floyd_warshall_cuda(A, M, integral)
        R = fw_ops.floyd_warshall_plain(A, M)
        torch.cuda.synchronize()
        differ = int((S.view(torch.int32) != R.view(torch.int32)).sum())
        err = float((S - R).abs().max())
        check(differ == 0, "K3 %s, %d graphs at V = %d (route %s, %s) "
              "bit-identical to plain (%d entries differ)"
              % (what, n, V, route, inst, differ))
        big = route != "tile"

        def call():
            return fw_ops.floyd_warshall_cuda(A, M, integral)

        # 2 V^3 min-plus operations a graph; adj and mask read once, S
        # written once
        ops = 2.0 * n * V ** 3
        nbytes = 8.0 * n * V * V + n * V
        t_ops, t_bytes = ops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
        dev_ms, records = (k3_device_ms(call, 3 if big else 20, V, route)
                           if profile else (None, 0))
        return {"what": what, "n": n, "V": V, "route": route,
                "instantiation": inst, "dynamic_smem_bytes": smem,
                "integral": integral,
                "differing": differ, "max_abs_err": err, "ops": ops,
                "bytes": nbytes, "ms": cuda_ms(call, 5 if big else reps),
                "device_ms": dev_ms, "device_records": records,
                "wrapper_ms": host_ms(call, 5 if big else reps),
                "plain_ms": cuda_ms(
                    lambda: fw_ops.floyd_warshall_plain(A, M),
                    1 if big else 3),
                "bound_ms": 1e3 * max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes"}

    def tile_sweep(A, M):
        """Route tile's time at every (T, G) that fits V, each checked
        bit for bit: the data behind ops.floyd_warshall.TILE_WIDTHS and
        fw_tile_config."""
        n, V = A.shape[:2]
        R = fw_ops.floyd_warshall_plain(A, M).view(torch.int32)
        rows = []
        for T, cap in sorted(fw_ops.TILE_MAX_THREADS.items()):
            tpg = (-(-V // T)) ** 2
            for G in (1, 2, 4, 8, 16, 32):
                if G * tpg > cap:
                    continue

                def call(T=T, G=G):
                    return fw_ops.floyd_warshall_cuda(A, M, tile=(T, G))

                same = torch.equal(call().view(torch.int32), R)
                rows.append({"T": T, "G": G, "threads": G * tpg,
                             "bit_identical": same, "ms": cuda_ms(call, 50)})
        check(all(r["bit_identical"] for r in rows),
              "K3 route tile at V = %d bit-identical at every (T, G)" % V)
        return rows

    def fw_batch(n, V, density, weighted, integer=False):
        A = (rng.rand(n, V, V) < density).astype(np.float32)
        if weighted:
            A *= rng.uniform(0.5, 2.0, (n, V, V)).astype(np.float32)
        if integer:
            A *= rng.randint(1, 5, (n, V, V)).astype(np.float32)
        A = np.triu(A, 1)
        A = A + A.transpose(0, 2, 1)
        M = np.zeros((n, V), bool)
        for g in range(n):
            M[g, :rng.randint(V // 2, V + 1)] = True
        return (torch.from_numpy(A).cuda(), torch.from_numpy(M).cuda())

    def bucket_cases(kernel, what, sweep=False, reps=50):
        out = []
        for _, A, _, M in kernel.X["buckets"]:
            A, M = torch.from_numpy(A).cuda(), torch.from_numpy(M).cuda()
            out.append(k3_case(A, M, what, kernel.X["unit"], reps))
            if sweep:
                out[-1]["tile_sweep"] = tile_sweep(A, M)
        return out

    # the main path's shapes: the NCI1-scale fit buckets
    k3 = bucket_cases(spk, "NCI1-scale fit bucket", sweep=True)
    k3_other = bucket_cases(wsp, "weighted NCI1-scale fit bucket")
    k3_other.append(k3_case(*fw_batch(256, 96, 0.04, True),
                            "weighted random batch"))
    k3_b = [k3_case(*fw_batch(4, 512, 0.008, True), "weighted, route per_k"),
            k3_case(*fw_batch(1, 1000, 0.004, True), "weighted, route per_k")]
    k3_bi = [k3_case(*fw_batch(4, 512, 0.008, False, True),
                     "integer weights 1-4, route blocked", True),
             k3_case(*fw_batch(1, 1000, 0.004, False, True),
                     "integer weights 1-4, route blocked", True)]
    k3_rb = bucket_cases(rbk, "REDDIT-B-scale 129-512 fit bucket", reps=5)
    # the stream slab route: K3 on each slab of sp_stream_slab's fit parse,
    # as the route launches it, and on one slab of the top bucket
    k3_stream = [k3_case(A, M.contiguous(), "stream slab", True, reps=5,
                         profile=False)
                 for A, M, _, _ in slab_k._slabs(slab_k.X)]
    k3_top = stream_top_slab(slab_k, top_graphs, check)
    del slab_k, top_graphs

    # ---------------- K4 against its plain version ---------------------- #
    def degree_inputs(graphs, bits, seed):
        """``graphs`` in a batch on the card, each vertex labeled by its
        out-degree through a seeded random bits-wide hash (as NH hashes
        labels), 1 % of them poisoned (a label unseen at fit)."""
        batch = GraphBatch.from_graphs(graphs, node_label_enum={},
                                       device="cuda")
        deg = torch.diff(batch.csr_offsets).long()
        r = np.random.RandomState(seed)
        lut = torch.from_numpy(r.randint(0, 1 << bits, int(deg.max()) + 1)
                               ).cuda()
        valid = batch.node_mask & torch.from_numpy(
            r.rand(deg.shape[0]) > 0.01).cuda()
        lab = torch.where(valid, lut[deg], 0).to(torch.int32)
        return batch, lab, valid

    def k4_case(batch, lab, valid, R, bits, cs, what, route, sweep=False):
        """K4 through ``nh_rounds`` (the call a parse makes) on ``batch``:
        on ``route`` (the launch counts say which), bit-identical to
        nh_rounds_plain on the card, timed beside its bound and the plain
        R rounds.  On the graph route also into a stack of garbage (every
        bin of every row written) with no fill kernel in the call's
        profile, and with ``sweep`` at several chunk sizes."""
        n, nh_type = batch.n_graphs, "count_sensitive" if cs else "simple"
        gids, off, tgt = (batch.node_graph_ids, batch.csr_offsets,
                          batch.csr_targets)
        before = (nh_ops.nh_graph_cuda.launches,
                  nh_ops.nh_round_cuda.launches)
        H = nh_ops.nh_rounds(batch, lab, valid, n, R, bits, cs)
        torch.cuda.synchronize()
        got = (nh_ops.nh_graph_cuda.launches - before[0],
               nh_ops.nh_round_cuda.launches - before[1])
        want = {"graph": (1, 0), "round": (0, R), "mixed": (1, R)}[route]
        P = nh_ops.nh_rounds_plain(lab, valid, gids, off, tgt, n, R, bits,
                                   cs)
        torch.cuda.synchronize()
        differ = int((H != P).sum())
        poisoned = int((batch.node_mask & ~valid).sum())
        deg = torch.diff(off)
        hub = nh_ops.K4_HUB_DEGREE[cs]
        check(differ == 0 and got == want,
              "K4 %s, %s, %d graphs, R = %d, bits = %d: route %s (graph and "
              "round launches %s), histograms bit-identical to plain (%d "
              "differ; %d poisoned nodes; max out-degree %d, %d nodes above "
              "the hub degree %d)" % (nh_type, what, n, R, bits, route, got,
                                      differ, poisoned, int(deg.max()),
                                      int((deg > hub).sum()), hub))

        def call():
            return nh_ops.nh_rounds(batch, lab, valid, n, R, bits, cs)

        N, E, L = lab.shape[0], tgt.shape[0], 1 << bits
        # each input once (label, validity, graph id, offset a node; the
        # target an edge), the R histograms written once
        nbytes = 13.0 * N + 4 + 4.0 * E + 4.0 * R * n * L
        by_name, _ = kernel_records(call, 20, ("nh_graph", "nh_round"))
        hits = [k for k in by_name if "nh_graph" in k or "nh_round" in k]
        wrapper = host_ms(call, 20)
        # the sleep outlasts enqueueing 100 calls twice over (the host
        # plans the chunks on every call: ~2 ms for 4110 graphs)
        busy = int(max(5e7, 4e6 * 100 * wrapper))
        row = {"what": what, "nh_type": nh_type, "route": route,
               "graphs": n, "nodes": N, "edges": E, "bits": bits,
               "poisoned_nodes": poisoned, "max_degree": int(deg.max()),
               "hub_degree": hub, "hub_nodes": int((deg > hub).sum()),
               "rounds": R, "launches": got, "differing": differ,
               "bytes": nbytes, "ms": cuda_ms(call, 100, 5, busy),
               "device_ms": sum(by_name[k] for k in hits) / 20 if hits
               else None,
               "wrapper_ms": wrapper,
               "plain_ms": cuda_ms(lambda: nh_ops.nh_rounds_plain(
                   lab, valid, gids, off, tgt, n, R, bits, cs), 5),
               "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
               "bound_by": "bytes",
               # the earlier count: every round's node and edge traffic
               "bound_ms_earlier_count": 1e3 * (R * (18.0 * N + 4 + 9.0 * E)
                                            + 4.0 * R * n * L)
               / HBM_BYTES_PER_S}
        check(row["device_ms"] is not None, "K4 %s, %s: device time from "
              "the profiler's records (%s ms)"
              % (nh_type, what, row["device_ms"]))
        if route == "graph":
            fills = [k for k in by_name if "fill" in k.lower()]
            chunks, _, smem = nh_ops.nh_plan(batch.n_nodes, batch.n_edges,
                                             bits)
            G = torch.full_like(P, -7)
            nh_ops.nh_graph_cuda(lab, valid, gids, off, tgt, chunks, G, bits,
                                 cs)
            torch.cuda.synchronize()
            check(torch.equal(G, P) and not fills,
                  "K4 %s, %s: the graph route writes every bin into a stack "
                  "of garbage (%d chunks, %d B of shared memory), and the "
                  "nh_rounds call runs no fill kernel (%s)"
                  % (nh_type, what, len(chunks), smem, fills))
            row.update(chunks=len(chunks), smem_bytes=smem)
        if sweep:
            row["chunk_sweep"] = {}
            for cn in (64, 128, 256, 512, 1024):
                chunks, _, smem = nh_ops.nh_plan(batch.n_nodes,
                                                 batch.n_edges, bits, cn)
                G = torch.full_like(P, -7)

                def gcall(chunks=chunks, G=G):
                    return nh_ops.nh_graph_cuda(lab, valid, gids, off, tgt,
                                                chunks, G, bits, cs)

                gcall()
                torch.cuda.synchronize()
                check(torch.equal(G, P), "K4 %s, %s, chunks of %d nodes: "
                      "bit-identical" % (nh_type, what, cn))
                row["chunk_sweep"][cn] = {"chunks": len(chunks),
                                          "smem_bytes": smem,
                                          "ms": cuda_ms(gcall, 100, 5,
                                                        busy)}
            # the out-degree above which a warp folds a node (0: every
            # node with an edge; 2^31 - 1: none)
            row["hub_sweep"] = {}
            chunks, _, _ = nh_ops.nh_plan(batch.n_nodes, batch.n_edges, bits)
            for hd in (0, 4, 8, 16, 32, 2 ** 31 - 1):
                G = torch.full_like(P, -7)

                def hcall(hd=hd, G=G):
                    return nh_ops.nh_graph_cuda(lab, valid, gids, off, tgt,
                                                chunks, G, bits, cs,
                                                hub_degree=hd)

                hcall()
                torch.cuda.synchronize()
                check(torch.equal(G, P), "K4 %s, %s, hub degree %d: "
                      "bit-identical" % (nh_type, what, hd))
                row["hub_sweep"][hd] = cuda_ms(hcall, 100, 5, busy)
        return row

    k4 = []
    for key in ("nh_nci1scale", "nh_cs_nci1scale"):
        kern = nh_kernels[key]
        cs = kern.nh_type == "count_sensitive"
        for graphs, what in ((train, "NCI1-scale fit batch"),
                             (held, "held-out batch, poisoned labels")):
            inputs = kern._round_inputs(normalize_input(graphs))
            k4.append(k4_case(*inputs, kern.R, kern.bits, cs, what, "graph",
                              sweep=what.startswith("NCI1")))
    wl_big, _ = generate_dataset(
        n_graphs=8, n_graphs_test=2, r_vertices=(5500, 6500),
        r_connectivity=(0.001, 0.002), random_state=3, features=("nl", 2))
    big = normalize_input(wl_big)
    hub_graphs = [Graph.from_arrays(n, s, r) for n, s, r in coo]
    mix = normalize_input(train[:150])
    mix = mix[:50] + big[:3] + mix[50:100] + big[3:] + mix[100:]
    for cs in (False, True):
        for graphs, what, route in (
                (hub_graphs, "REDDIT-B-scale stand-in, degree labels (hubs)",
                 "graph"),
                (big, "6 graphs of 5500-6500 vertices, degree labels",
                 "round"),
                (mix, "150 NCI1-scale graphs and the 6 large ones",
                 "mixed")):
            k4.append(k4_case(*degree_inputs(graphs, 8, SEED), 3, 8, cs,
                              what, route))

    # ---------------- K5 against its plain version ---------------------- #
    def k5_case(kern, key, route):
        """K5 on the NH path's per-round counts on ``route``: the fit
        Gram's (triangle, as the path takes it, or pair) or the
        transform's (rect, 64 x 4110), bit-identical to the plain fold and
        to the path's Gram; the triangle route also with the tiles below
        the diagonal poisoned (it must not read them)."""
        X = kern.X["hists"]
        vx = torch.tensor(kern.X["nv"], dtype=torch.float32, device="cuda")
        sym, tri = route != "rect", route == "triangle"
        if sym:
            C = intersect.min_intersection_gram_rounds(X, route=None)
            va = vb = vx
            ref = paths_out[key][0]
        else:
            Y = kern._Y["hists"]
            C = intersect.min_intersection_gram_rounds(Y, X, route=None)
            va = torch.tensor(kern._Y["nv"], dtype=torch.float32,
                              device="cuda")
            vb = vx
            ref = paths_out[key][1]
        R, n, m = C.shape
        before = intersect.jaccard_fold_cuda.route_launches[route]
        K = intersect.jaccard_fold_cuda(C, va, vb, sym, triangle=tri)
        P = intersect.jaccard_fold_plain(C, va, vb, sym)
        torch.cuda.synchronize()
        took = intersect.jaccard_fold_cuda.route_launches[route] - before
        differ = int((K.view(torch.int32) != P.view(torch.int32)).sum())
        same_path = np.array_equal(K.double().cpu().numpy(), ref)
        check(differ == 0 and same_path and took == 1,
              "K5 %s %s %dx%d, R = %d: route %s, bit-identical to the plain "
              "fold (%d differ) and to the path's Gram (%s)"
              % (kern.nh_type, route, n, m, R, route, differ, same_path))
        upper_only = None
        if tri:
            t = torch.arange(n, device="cuda") // intersect.K5_TILE
            Cp = C.masked_fill(t[:, None] > t[None, :], float("nan"))
            Kp = intersect.jaccard_fold_cuda(Cp, va, va, True, triangle=True)
            torch.cuda.synchronize()
            upper_only = torch.equal(Kp.view(torch.int32),
                                     K.view(torch.int32))
            check(upper_only, "K5 %s triangle: the same ratios with the "
                  "tiles below the diagonal NaN (it reads the upper block "
                  "triangle only)" % kern.nh_type)
            del Cp, Kp

        def call():
            return intersect.jaccard_fold_cuda(C, va, vb, sym, triangle=tri)

        # counts read once (the distinct ones on the triangle route), the
        # vertex counts once, the ratios written once; a division and four
        # adds an entry and round, the mean (and the pair's symmetrization)
        if tri:
            entries = n * (n + 1) / 2
            nbytes = 4.0 * (R * entries + n * m + n)
            ops = 5.0 * R * entries + n * m
        else:
            nbytes = 4.0 * (R * n * m + n * m + n + (0 if sym else m))
            ops = 5.0 * R * n * m + (3.0 if sym else 1.0) * n * m
        t_ops, t_bytes = ops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
        dev = device_ms(call, 10, "jaccard_")
        check(dev is not None, "K5 %s %s %dx%d: device time from the "
              "profiler's records (%s ms)" % (kern.nh_type, route, n, m,
                                              dev))
        return {"nh_type": kern.nh_type, "route": route, "n": n, "m": m,
                "R": R, "symmetric": sym, "differing": differ,
                "upper_triangle_only": upper_only, "bytes": nbytes,
                "ops": ops, "max_abs_err": float((K - P).abs().max()),
                "ms": cuda_ms(call, 20), "device_ms": dev,
                "wrapper_ms": host_ms(call, 20),
                "plain_ms": cuda_ms(lambda: intersect.jaccard_fold_plain(
                    C, va, vb, sym), 3),
                "bound_ms": 1e3 * max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                # the earlier count: every count of the square read
                "bound_ms_earlier_count": 1e3 * 4.0 * (R * n * m + n * m + n
                                                   + m) / HBM_BYTES_PER_S}

    k5 = [k5_case(nh_kernels[key], key, route)
          for key in ("nh_nci1scale", "nh_cs_nci1scale")
          for route in (("triangle", "rect", "pair")
                        if key == "nh_nci1scale" else ("triangle", "rect"))]

    # ---------------- K6 against its plain version ---------------------- #
    def k6_case(batch, table, row, tags, what, route, n_iter=5,
                main=False):
        """K6 through ``hadamard_generations`` (the call HadamardCode's
        fast path makes) on ``batch``: every generation's keys
        bit-identical to hadamard_generations_plain on the card, on
        ``route`` (the launches per route must be hc_plan's: one
        graph-route launch, and n_iter round-route ones when a graph does
        not fit a block); timed beside its bound, the plain version and
        the int32 ``index_add_`` of the neighbours' rows (the neighbour
        sum alone).  ``main`` also times the earlier design on the
        same inputs (every row from device memory, a launch a
        generation), the planner alone, the route at 1-4 generations and
        a sweep of the shared memory budget."""
        off, tgt = batch.csr_offsets, batch.csr_targets
        N, D = row.shape[0], table.shape[1]
        chunks, rnd, smem = hc_ops.hc_plan(batch.n_nodes, batch.n_edges, D,
                                           N, hc_ops.K6_SMEM_BUDGET)
        before = k6_routes()
        key = hc_ops.hadamard_generations(batch, table, row, tags, n_iter)
        torch.cuda.synchronize()
        took = tuple(a - b for a, b in zip(k6_routes(), before))
        want = hc_ops.hadamard_generations_plain(table, row, off, tgt, tags,
                                                 n_iter)
        torch.cuda.synchronize()
        differ = int((key != want).sum())
        got_route = ("graph" if not len(rnd) else "round"
                     if len(rnd) == batch.n_graphs else "mixed")
        nodes, E = batch.total_nodes, tgt.shape[0]
        deg = torch.diff(off.long())
        send = torch.repeat_interleave(torch.arange(N, device="cuda"), deg)
        tgt_l = tgt.long()
        codes = table[row.long()]
        wide = codes.long().index_add(0, send, codes.long()[tgt_l])
        wrapped = int((wide.abs() >= 2 ** 31).any(1).sum())
        del wide
        check(differ == 0 and took == (1, n_iter if len(rnd) else 0)
              and got_route == route,
              "K6 %s, D = %d, %d generations: keys bit-identical to plain "
              "(%d differ; max out-degree %d; %d rows' first sums past the "
              "int32 range), route %s (%s wanted; %d chunks, %d B of shared "
              "memory, %d graphs on the round route), graph and round "
              "launches %s" % (what, D, n_iter, differ, int(deg.max()),
                               wrapped, got_route, route, len(chunks), smem,
                               len(rnd), took))

        def call():
            return hc_ops.hadamard_generations(batch, table, row, tags,
                                               n_iter)

        def neighbour_sum():
            return codes.index_add(0, send, codes[tgt_l])

        # the function's own bytes: each valid node's row index, tag and
        # CSR offset (and one more offset), each edge's target and the
        # table read once, n_iter keys a node written once; operations:
        # ~24 integer operations an element a generation (two positions,
        # two fmix32, two sums), one an edge and column a propagating one
        nbytes = 12.0 * nodes + 4 + 4.0 * E + 4.0 * table.numel() \
            + 8.0 * n_iter * nodes
        ops = 24.0 * nodes * D * n_iter + 1.0 * E * D * (n_iter - 1)
        t_ops, t_bytes = ops / INT32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
        # the earlier count, a generation at a time: every row, tag and
        # key moved each generation, and each propagating one its offsets,
        # its targets and the new rows
        per_gen = n_iter * (4.0 * nodes * D + 12.0 * nodes) + (n_iter - 1) \
            * (4.0 * (nodes + 1) + 4.0 * E + 4.0 * nodes * D)
        by_name, _ = kernel_records(call, 20, ("hadamard_",))
        hits = [k for k in by_name if "hadamard_" in k]
        wrapper = host_ms(call, 20)
        # the sleep outlasts enqueueing the timed calls twice over (the
        # host plans the chunks on every call)
        busy = int(max(5e7, 4e6 * 100 * wrapper))
        row_ = {"what": what, "D": D, "n_iter": n_iter, "route": got_route,
                "graphs": batch.n_graphs, "nodes": nodes, "rows": N,
                "edges": E, "table_rows": table.shape[0],
                "max_degree": int(deg.max()), "wrapped_rows": wrapped,
                "chunks": len(chunks), "smem_bytes": smem,
                "round_graphs": len(rnd), "launches": took,
                "differing": differ, "bytes": nbytes, "ops": ops,
                "ms": cuda_ms(call, 100, 5, busy),
                "device_ms": sum(by_name[k] for k in hits) / 20 if hits
                else None,
                "wrapper_ms": wrapper,
                "plain_ms": cuda_ms(lambda: hc_ops.hadamard_generations_plain(
                    table, row, off, tgt, tags, n_iter), 3),
                "index_add_ms": (n_iter - 1) * cuda_ms(neighbour_sum, 20),
                "bound_ms": 1e3 * max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "bound_ms_per_generation_count": 1e3 * max(
                    t_ops, per_gen / HBM_BYTES_PER_S),
                # the same operations at the fp32 rate
                "bound_ms_fp32_rate": 1e3 * max(ops / FP32_OPS_PER_S,
                                                t_bytes)}
        check(row_["device_ms"] is not None, "K6 %s, D = %d: device time "
              "from the profiler's records (%s ms, kernels %s)"
              % (what, D, row_["device_ms"], hits))
        if not main:
            return row_
        # the earlier design: the rows gathered once, then a launch a
        # generation over all rows from device memory into two buffers
        first = codes.contiguous()

        def five_launches():
            cur, spare, keys = first, None, []
            for g in range(n_iter):
                nxt, k = k6_count(cur, off, tgt, tags, g > 0, out=spare)
                if g > 0:
                    spare = cur if cur is not first else None
                    cur = nxt
                keys.append(k)
            return keys

        old = torch.stack(five_launches())
        torch.cuda.synchronize()
        check(torch.equal(old, want), "K6 %s: the earlier five-launch "
              "design gives the same keys" % what)
        row_["five_launch_ms"] = cuda_ms(five_launches, 100, 5)
        # the graph route's time by generation count: its slope is a
        # propagating generation's, its intercept the staging's
        row_["n_iter_sweep"] = {}
        for it in (1, 2, 3, 4):
            got = hc_ops.hadamard_generations(batch, table, row, tags, it)
            torch.cuda.synchronize()
            check(torch.equal(got, want[:it]), "K6 %s, %d generations: "
                  "bit-identical" % (what, it))
            row_["n_iter_sweep"][it] = cuda_ms(
                lambda it=it: hc_ops.hadamard_generations(
                    batch, table, row, tags, it), 100, 5, busy)
        row_["n_iter_sweep"][n_iter] = row_["ms"]
        row_["planner_ms"] = host_ms(lambda: hc_ops.hc_plan(
            batch.n_nodes, batch.n_edges, D, N, hc_ops.K6_SMEM_BUDGET), 20)
        row_["budget_sweep"] = {}
        default = hc_ops.K6_SMEM_BUDGET
        try:
            for kb in (32, 48, 64, 96, 112, 160, 224):
                hc_ops.K6_SMEM_BUDGET = kb * 1024
                ch, rn, sm = hc_ops.hc_plan(batch.n_nodes, batch.n_edges, D,
                                            N, kb * 1024)
                got = call()
                torch.cuda.synchronize()
                check(torch.equal(got, want) and not len(rn),
                      "K6 %s, budget %d KB: bit-identical, graph route "
                      "only (%d chunks, %d B)" % (what, kb, len(ch), sm))
                row_["budget_sweep"][kb] = {"chunks": len(ch),
                                            "smem_bytes": sm,
                                            "ms": cuda_ms(call, 100, 5,
                                                          busy)}
        finally:
            hc_ops.K6_SMEM_BUDGET = default
        return row_

    def k6_inputs(graphs, D, kind, seed):
        """``graphs`` in a batch on the card, a table and row indices (the
        padding rows on a zero row) and random u32 tags: a table of a
        quarter as many rows as nodes with codes in [-3, 3] ("small"), or
        a row a node over the whole int32 range ("wrap": the neighbour
        sums pass 2^31 and wrap)."""
        batch = GraphBatch.from_graphs(graphs, node_label_enum={},
                                       device="cuda")
        N, n = batch.node_labels.shape[0], batch.total_nodes
        r = np.random.RandomState(seed)
        if kind == "wrap":
            table = r.randint(-2 ** 31, 2 ** 31, (n + 1, D), dtype=np.int64)
            row = np.minimum(np.arange(N), n)
        else:
            table = r.randint(-3, 4, (n // 4 + 2, D))
            row = r.randint(0, len(table) - 1, N)
            row[n:] = len(table) - 1
        table[-1] = 0
        tags = r.randint(0, 2 ** 31, N)
        return (batch,) + tuple(torch.from_numpy(a.astype(np.int32)).cuda()
                                for a in (table, row, tags))

    # the hc_nci1scale path's own inputs: its fit batch (D = 64, one tag)
    # and its transform batch (the fit and held-out graphs, tags Dx and Dt
    # over D_pad columns, the held-out rows after the fit table's)
    fit_graphs, held_graphs = normalize_input(train), normalize_input(held)
    hb = GraphBatch.from_graphs(fit_graphs, node_label_enum={},
                                device="cuda")
    hD = hck._hdim(len(hck._enum))
    table, row = (torch.from_numpy(a).cuda() for a in hck._code_table(
        hb, [hck._initial_codes(fit_graphs, hck._enum, hD)]))
    htags = torch.full((row.shape[0],), hD, dtype=torch.int32,
                       device="cuda")
    k6 = k6_case(hb, table, row, htags, "hc_nci1scale fit batch", "graph",
                 main=True)
    enum_t = hck._collect_labels(held_graphs, dict(hck._enum))
    Dx, Dt = hck._hdim(len(hck._enum)), hck._hdim(len(enum_t))
    tb = GraphBatch.from_graphs(fit_graphs + held_graphs, node_label_enum={},
                                device="cuda")
    table, row = (torch.from_numpy(a).cuda() for a in hck._code_table(
        tb, [hck._initial_codes(fit_graphs, hck._enum, max(Dx, Dt)),
             hck._initial_codes(held_graphs, enum_t, max(Dx, Dt))]))
    ttags = torch.full((row.shape[0],), Dt, dtype=torch.int32, device="cuda")
    ttags[:hb.total_nodes] = Dx
    k6_transform = k6_case(tb, table, row, ttags, "hc_nci1scale transform "
                           "batch (tags %d and %d)" % (Dx, Dt), "graph")
    k6_widths = []
    for D in (1, 2, 8, 32, 64, 128, 1024):
        b, tab, rw, tg = k6_inputs(fit_graphs, D, "small", SEED + D)
        route = hc_ops.hc_plan(b.n_nodes, b.n_edges, D, rw.shape[0])[1]
        k6_widths.append(k6_case(b, tab, rw, tg, "NCI1-scale fit batch, "
                                 "random table", "graph" if D < 1024
                                 else "mixed" if len(route) < b.n_graphs
                                 else "round"))
    k6_hub = []
    for D, route in ((1, "graph"), (64, "mixed")):
        b, tab, rw, tg = k6_inputs(hub_graphs, D, "small", SEED)
        k6_hub.append(k6_case(b, tab, rw, tg, "REDDIT-B-scale stand-in "
                              "(hubs)", route))
    b, tab, rw, tg = k6_inputs(fit_graphs, 64, "wrap", SEED)
    k6_wrap = k6_case(b, tab, rw, tg, "NCI1-scale fit batch, codes over the "
                      "int32 range", "graph")
    check(k6_wrap["wrapped_rows"] > 0, "K6's wrap batch: %d rows' sums "
          "passed the int32 range" % k6_wrap["wrapped_rows"])
    check(k6_hub[0]["max_degree"] > 200, "K6's hub batch: max out-degree "
          "%d" % k6_hub[0]["max_degree"])
    check(k6_widths[-1]["round_graphs"] > 0, "K6 at D = 1024: %d graphs on "
          "the round route" % k6_widths[-1]["round_graphs"])
    del b, tab, rw, tg, table, row

    # ------- K1 through min_intersection_gram_rounds (reach 2) ---------- #
    def rounds_case(A, B, integer, what):
        R, n, L = A.shape
        m = B.shape[1]
        before = intersect.min_gram_cuda.launches
        K = intersect.min_intersection_gram_rounds(A, B)
        torch.cuda.synchronize()
        calls = intersect.min_gram_cuda.launches - before
        P = torch.stack([intersect.min_gram_plain(A[q], B[q])
                         for q in range(R)])
        err = float((K - P).abs().max())
        ok = torch.equal(K, P) if integer else torch.allclose(
            K, P, rtol=1e-5, atol=1e-4)
        check(ok and calls == R and K.shape == (R, n, m),
              "min_intersection_gram_rounds %s [%d, %d, %d] x [%d, %d, %d]: "
              "%d K1 calls, == %d min_gram_plain calls (max abs err %g)"
              % (what, R, n, L, R, m, L, calls, R, err))
        sym = B is A
        ops = 2.0 * R * L * (n * (n + 1) / 2 if sym else n * m)
        nbytes = 4.0 * R * ((n if sym else n + m) * L + n * m)
        t_ops, t_bytes = ops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S

        def call():
            return intersect.min_intersection_gram_rounds(A, B)

        dev = device_ms(call, 10, "min_gram_kernel", R)
        check(dev is not None, "min_intersection_gram_rounds %s: device "
              "time from the profiler's records (%s ms)" % (what, dev))
        return {"what": what, "R": R, "n": n, "m": m, "L": L,
                "symmetric": sym, "launches": calls, "max_abs_err": err,
                "ms": cuda_ms(call, 10), "device_ms": dev,
                "wrapper_ms": host_ms(call, 10),
                "plain_ms": cuda_ms(lambda: [intersect.min_gram_plain(
                    A[q], B[q]) for q in range(R)], 1),
                "library_ms": cuda_ms(lambda: [torch.cdist(
                    A[q], B[q], p=1) for q in range(R)], 2),
                "bound_ms": 1e3 * max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes"}

    Xnh = nh_kernels["nh_nci1scale"].X["hists"]
    k1_rounds = [
        rounds_case(Xnh, Xnh, True, "NH simple fit stack, symmetric"),
        rounds_case(torch.from_numpy(rng.rand(3, 37, 333).astype(
            np.float32)).cuda(), torch.from_numpy(rng.rand(
                3, 1001, 333).astype(np.float32)).cuda(), False,
            "ragged real-valued rect")]

    def total(cases, key):
        vals = [c[key] for c in cases]
        return None if None in vals else sum(vals)

    def row_bound_by(cases, ops_rate, op_bytes):
        t_ops = total(cases, "ops") / ops_rate
        t_bytes = total(cases, op_bytes) / HBM_BYTES_PER_S
        return "operations" if t_ops >= t_bytes else "bytes"

    launches = {k: sum(p["launches"][k] for p in paths.values())
                for k in counters}
    launches["jaccard_fold_by_route"] = {
        r: sum(p["launches"]["jaccard_fold_by_route"][r]
               for p in paths.values()) for r in k5_routes}
    kernels = [
        {"name": "min_gram", "route": "cuda",
         "source": "grakel_torch/csrc/min_gram.cu",
         "replaces": "grakel_tpu/ops/intersect.py:55",
         "launches": launches["min_gram"],
         "max_abs_err": max(c["max_abs_err"] for c in
                            k1 + k1_levels + k1_labeled + k1_rect
                            + [ragged, acc_case]),
         "ms": total(k1, "ms"), "device_ms": total(k1, "device_ms"),
         "wrapper_ms": total(k1, "wrapper_ms"),
         "plain_ms": total(k1, "plain_ms"),
         "bound_ms": total(k1, "bound_ms"),
         "bound_by": row_bound_by(k1, FP32_OPS_PER_S, "bytes"),
         "library_ms": total(k1, "library_ms"),
         "summed_over": "the one K1 call of the unlabeled PM fit_transform "
                        "Gram: its four levels scaled by their integer "
                        "weights and concatenated, 2000 x 2000 x 90, "
                        "symmetric (the block triangle)",
         "ptxas": k1_ptxas, "shapes": k1,
         "per_level_shapes": {
             k: total(k1_levels, k) for k in
             ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms")},
         "per_level": k1_levels,
         "labeled_levels": k1_labeled, "labeled_levels_rect": k1_rect,
         "ragged_real_check": ragged, "symmetric_vs_rect_checks": sym_checks,
         "accumulate_check": acc_case,
         "gram_stage": gram_stage,
         "rounds": {"replaces": "grakel_tpu/ops/intersect.py:98 "
                                "(_min_gram_rounds_impl, reach 2)",
                    "shapes": k1_rounds}},
        {"name": "min_gram_tc", "route": "cuda",
         "source": "grakel_torch/csrc/min_gram_tc.cu",
         "replaces": "grakel_tpu/ops/intersect.py:55",
         "mirrors": "grakel_tpu/ops/intersect.py:244 (_min_gram_gemm)",
         "launches": launches["min_gram_tc"],
         "max_abs_err": max(c["max_abs_err"] for c in
                            tc + tc_rect + tc_nh + [tc_pm, tc_pm_rect,
                                                    tc_ragged] + tc_ragged_w),
         # the main path's call (PM labeled fit_transform: its K1-tc
         # levels weighted and concatenated, ONE launch), the expansion
         # included
         "ms": tc_pm["with_expansion_ms"],
         "kernel_ms": tc_pm["ms"], "device_ms": tc_pm["device_ms"],
         "wrapper_ms": tc_pm["wrapper_ms"],
         "expansion_ms": tc_pm["expansion_ms"],
         "plain_ms": tc_pm["plain_ms"],
         "bound_ms": tc_pm["bound_ms"], "bound_by": tc_pm["bound_by"],
         "bound_ms_per_level_count": tc_pm["bound_ms_per_level_count"],
         "library_ms": tc_pm["library_ms"],
         "library": "torch._int_mm on the same indicators (the full square)",
         "mma_design": {
             "summed_over": "the mma.sync design at the same levels: one "
                            "torch expansion and one mma.sync launch a "
                            "level",
             "ms": total(tc, "mma_ms"),
             "expansion_ms": total(tc, "mma_expansion_ms"),
             "transform_ms": total(tc_rect, "mma_ms"),
             "transform_expansion_ms": total(tc_rect, "mma_expansion_ms")},
         "per_level": {
             "summed_over": "the four labeled levels, one call each "
                            "(the break-even against K1)",
             **{k: total(tc, k) for k in (
                 "ms", "with_expansion_ms", "bound_ms", "library_ms",
                 "k1_ms")}},
         "break_even_ratio": be_sym, "break_even_ratio_rect": be_rect,
         "summed_over": "the one K1-tc call of the PM labeled "
                        "fit_transform Gram: %d levels, %d x %d, W' %d, "
                        "weighted, symmetric, its expansion (one launch) "
                        "included" % (len(l_tc), N_GRAPHS, N_GRAPHS,
                                      tc_pm["w_expanded"]),
         "pm_fused": tc_pm, "pm_fused_transform": tc_pm_rect,
         "nh_calls": {
             "summed_over": "the NH simple path's two calls: its fit "
                            "Gram's three rounds (4110 x 4110, symmetric) "
                            "in one launch and its transform's (3 x 64 x "
                            "4110) in one",
             **{k: total(tc_nh, k) for k in (
                 "ms", "with_expansion_ms", "device_ms", "expansion_ms",
                 "plain_ms", "bound_ms", "library_ms", "mma_ms",
                 "mma_expansion_ms")},
             "bound_by": row_bound_by(tc_nh, INT8_OPS_PER_S, "bytes"),
             "fit": {k: tc_nh[0][k] for k in (
                 "ms", "with_expansion_ms", "bound_ms", "library_ms",
                 "mma_ms")},
             "transform": {k: tc_nh[1][k] for k in (
                 "ms", "with_expansion_ms", "bound_ms", "library_ms",
                 "mma_ms", "tile_sweep")},
             "shapes": tc_nh},
         "ptxas": tc_ptxas,
         "shapes": tc, "transform_shapes": tc_rect,
         "ragged_rect_check": tc_ragged, "ragged_weighted": tc_ragged_w},
        {"name": "threshold_expand", "route": "cuda",
         "source": "grakel_torch/csrc/min_gram_tc.cu",
         "replaces": "grakel_tpu/ops/intersect.py:244 (the indicators of "
                     "_min_gram_gemm)",
         "launches": launches["threshold_expand"],
         "max_abs_err": max(c["expansion_differing"] for c in
                            tc + tc_rect + tc_nh + [tc_pm, tc_pm_rect,
                                                    tc_ragged] + tc_ragged_w),
         "ms": tc_pm["expansion_ms"],
         "plain_ms": tc_pm["expansion_plain_ms"],
         "bound_ms": tc_pm["expansion_bound_ms"], "bound_by": "bytes",
         "library_ms": None,
         "library": "none: no single PyTorch call writes the indicators",
         "summed_over": "the expansion of the PM labeled fit_transform "
                        "call: the weighted and the 0/1 indicators in one "
                        "launch (the f32 counts read, both written once)",
         "nh_calls_ms": total(tc_nh, "expansion_ms")},
        {"name": "wl_hash_refine", "route": "cuda",
         "source": "grakel_torch/csrc/wl_hash.cu",
         "replaces": "grakel_tpu/ops/wl.py:71; reach 2: the hash of "
                     "grakel_tpu/parallel/large_graph.py:47 (_refine_step)",
         "launches": launches["wl_hash_refine"]
         + launches["wl_hash_refine_rows"],
         "route_launches": {"reach_1": launches["wl_hash_refine"],
                            "reach_2": launches["wl_hash_refine_rows"]},
         "max_abs_err": max(k2_err, k2r["max_abs_err"]), "ms": k2["ms"],
         "device_ms": k2["device_ms"], "wrapper_ms": k2["wrapper_ms"],
         "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": "bytes",
         "library_ms": None,
         "library": "none: no PyTorch call computes the hash",
         "summed_over": "one reach-1 call over the NCI1-scale batch's CSR",
         "shapes": [k2],
         "reach_2": dict(k2r, summed_over="the arxiv-sized graph's rows "
                         "in four blocks, one launch each, as four ranks "
                         "run a generation")},
        {"name": "floyd_warshall", "route": "cuda",
         "source": "grakel_torch/csrc/floyd_warshall.cu",
         "replaces": "grakel_tpu/ops/floyd_warshall.py:30",
         "launches": launches["floyd_warshall"],
         "max_abs_err": max(c["max_abs_err"] for c in
                            k3 + k3_other + k3_b + k3_bi + k3_rb
                            + k3_stream),
         "ms": total(k3, "ms"), "device_ms": total(k3, "device_ms"),
         "wrapper_ms": total(k3, "wrapper_ms"),
         "plain_ms": total(k3, "plain_ms"),
         "bound_ms": total(k3, "bound_ms"),
         "bound_by": row_bound_by(k3, FP32_OPS_PER_S, "bytes"),
         "library_ms": None,
         "library": "none: no single PyTorch call computes APSP",
         "summed_over": "one call per NCI1-scale fit bucket (the calls "
                        "one fit_transform makes)",
         "ptxas": k3_ptxas,
         "shapes": k3, "other_route_tile": k3_other, "route_per_k": k3_b,
         "route_blocked": k3_bi,
         "stream_slab_route": {
             "path": "sp_stream_slab",
             "launches": paths["sp_stream_slab"]["launches"][
                 "floyd_warshall"],
             "by_route": paths["sp_stream_slab"]["launches"][
                 "floyd_warshall_by_route"],
             "slabs": paths["sp_stream_slab"]["slabs"],
             "summed_over": "one K3 call a slab of the path's fit parse "
                            "(%d slabs)" % len(k3_stream),
             "ms": total(k3_stream, "ms"),
             "device_ms": total(k3_stream, "device_ms"),
             "plain_ms": total(k3_stream, "plain_ms"),
             "bound_ms": total(k3_stream, "bound_ms"),
             "bound_by": row_bound_by(k3_stream, FP32_OPS_PER_S, "bytes"),
             "shapes": [{k: c[k] for k in ("n", "V", "route", "ms",
                                           "device_ms", "plain_ms",
                                           "bound_ms", "differing")}
                        for c in k3_stream],
             "top_bucket": k3_top},
         "redditb_fit_buckets": {
             "ms": total(k3_rb, "ms"), "device_ms": total(k3_rb, "device_ms"),
             "plain_ms": total(k3_rb, "plain_ms"),
             "bound_ms": total(k3_rb, "bound_ms"),
             "bound_by": row_bound_by(k3_rb, FP32_OPS_PER_S, "bytes"),
             "shapes": [{k: c[k] for k in ("n", "V", "route", "ms",
                                           "device_ms", "plain_ms",
                                           "bound_ms")} for c in k3_rb]}},
        {"name": "nh_hash", "route": "cuda",
         "source": "grakel_torch/csrc/nh_hash.cu",
         "replaces": "grakel_tpu/kernels/neighborhood_hash.py:226",
         "launches": launches["nh_graph"] + launches["nh_round"],
         "route_launches": {"graph": launches["nh_graph"],
                            "round": launches["nh_round"]},
         "max_abs_err": max(c["differing"] for c in k4),
         **{k: k4[0][k] for k in ("ms", "device_ms", "wrapper_ms",
                                  "plain_ms", "bound_ms", "bound_by",
                                  "bound_ms_earlier_count")},
         "library_ms": None,
         "library": "none: no single PyTorch call computes a hash round",
         "summed_over": "one nh_rounds call, the R = 3 rounds of one parse "
                        "of the NCI1-scale fit set, simple (one graph-route "
                        "launch)",
         "ptxas": {k: v for k, v in k45_ptxas.items() if "nh_" in k},
         "shapes": k4},
        {"name": "jaccard_fold", "route": "cuda",
         "source": "grakel_torch/csrc/jaccard.cu",
         "replaces": "grakel_tpu/ops/intersect.py:153",
         "launches": launches["jaccard_fold"],
         "max_abs_err": max(c["max_abs_err"] for c in k5),
         "route_launches": dict(launches["jaccard_fold_by_route"]),
         **{k: k5[0][k] for k in ("ms", "device_ms", "wrapper_ms",
                                  "plain_ms", "bound_ms", "bound_by",
                                  "bound_ms_earlier_count")},
         "library_ms": None,
         "library": "none: no single PyTorch call computes the fold",
         "summed_over": "the fold of the simple NH fit_transform Gram, "
                        "4110 x 4110, R = 3, on the triangle route",
         "ptxas": {k: v for k, v in k45_ptxas.items() if "jaccard" in k},
         "shapes": k5},
        {"name": "hadamard", "route": "cuda",
         "source": "grakel_torch/csrc/hadamard.cu",
         "replaces": "grakel_tpu/kernels/hadamard_code.py:50,199",
         "launches": launches["hadamard_graph"] + launches["hadamard_step"],
         "route_launches": {"graph": launches["hadamard_graph"],
                            "round": launches["hadamard_step"]},
         "max_abs_err": max(c["differing"] for c in
                            [k6, k6_transform] + k6_widths + k6_hub
                            + [k6_wrap]),
         **{k: k6[k] for k in ("ms", "device_ms", "wrapper_ms", "plain_ms",
                               "bound_ms", "bound_by",
                               "bound_ms_per_generation_count",
                               "bound_ms_fp32_rate",
                               "index_add_ms", "five_launch_ms",
                               "planner_ms")},
         "library_ms": None,
         "library": "none: no single PyTorch call computes the row hash",
         "index_add": "the neighbour sum alone, int32 index_add_ of the "
                      "gathered rows, over the four propagating generations",
         "five_launch": "the earlier design on the same inputs: the rows "
                        "gathered into device memory, one round-route "
                        "launch a generation over every row",
         "summed_over": "one hadamard_generations call, the five "
                        "generations of one HadamardCode(n_iter=5) "
                        "fit_transform on the NCI1-scale fit batch, D = %d, "
                        "graph route (one launch)" % hD,
         "ptxas": k6_ptxas, "shapes": [k6, k6_transform],
         "widths": k6_widths, "hub_batch": k6_hub, "wrap_batch": k6_wrap},
    ]
    for row in k789:
        row["launches"] = launches[row["name"]]
        row["ptxas"] = {k: v for k, v in k789_ptxas.items()
                        if row["name"] in k}
    k789[1]["route_launches"] = {
        r: sum(p["launches"]["rw_cg_by_route"][r] for p in paths.values())
        for r in k8_routes}
    print("rw_cg: launches by route over the paths %s"
          % k789[1]["route_launches"], flush=True)
    kernels += k789
    for row, key in zip(k1013, ("svm_lanczos", "svm_fista", "lovasz_dr_step",
                                "lovasz_min_cone", "lovasz_jacobi_eigh")):
        row["launches"] = launches[key]
        row["ptxas"] = {k: v for k, v in k1013_ptxas.items()
                        if (key if "lovasz" in key else "svm_solve") in k}
        if "path_kernels" in row:
            row["ptxas_path"] = {k: row["ptxas"].get(k)
                                 for k in row["path_kernels"]}
            print("%s: the path's kernels %s" % (key, row["ptxas_path"]),
                  flush=True)
    kernels += k1013
    for row in k1516:
        row["launches"] = launches[row["name"]]
        row["ptxas"] = {k: v for k, v in k1516_ptxas.items()
                        if row["name"] in k}
    kernels += k1516
    for row in k17:
        row["launches"] = launches[row["name"]]
        row["ptxas"] = k17_ptxas
    kernels += k17
    check(all(r["launches"] > 0 for r in kernels),
          "every kernel of the line launched on the paths: %s"
          % {r["name"]: r["launches"] for r in kernels})
    print(json.dumps({"kernels": kernels}), flush=True)
    print("chip_smoke: %.1f s in all, the build included"
          % (time.perf_counter() - t_start), flush=True)
    print("nvidia-smi: %s" % smi, flush=True)
    if check.failed:
        print("chip_smoke: %d check(s) failed: %s"
              % (len(check.failed), "; ".join(check.failed)),
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
