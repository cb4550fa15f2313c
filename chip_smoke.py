#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``distributedkernelshap_tpu_torch``) on one
CUDA card: builds every kernel from ``csrc/``, holds each against its plain
PyTorch version on the card, drives the Adult headline explain, the exact
TreeSHAP and exact interaction explains of an Adult-shaped GBT, the
sampled engine's packed copy, l1 selection, plan-constant path and
device-side importance, the non-linear sampled paths (the GBT's and an
MLP's ``masked_ey``, torch modules, a numpy black box on the host-eval and
generic routes), the engine's serving entry points (instance chunks,
staged async explains, anytime rounds, profiler phases, save/load), the
GBT lifted from xgboost and LightGBM dumps, an affine output head, an
IsolationForest-shaped ensemble, exact tensor-train SHAP, the singular-Gram
NaN path, the JAX package's own answers from a committed fixture, and
scikit-learn compositions, SVMs and Gaussian classifiers behind stand-in
estimators (a folded Pipeline on ``fused_linear_ey``, forwarding ensembles
whose linear members launch it, a second fixture of real scikit-learn
fits), the ONNX graph lift (its ops, a logistic-regression export on
``fused_linear_ey``), DeepSHAP over lifted graphs and the MNIST CNN with
superpixel image explanations (a third fixture of the JAX package's
answers), the explanation server, its gateway, fleet and shard journal,
explains over a mesh of devices driven from one process (the headline
and the exact paths at several layouts on the one card) and the CNN's
training, and the same mesh across processes joined by ``torch.distributed``
(two worker processes of this script on the one card, one at world size 1
on NCCL) and a two-process pod behind the fleet's proxy, through the public
API, then the port's static gate (``scripts/torch_lint.py --check``) on this
machine and the runtime lock witness over a server on the card, checks the
answers, then the shapes past the kernels' old limits (a 100-class LR, the
Covertype configuration on all its rows, exact TreeSHAP of GBTs over 100
and 300 columns, exact interactions over 64), and times kernels, plain
versions and explains.

    python3 chip_smoke.py [--seed 0]

Phases (each raises on failure, so the script exits non-zero):

1. device: the card's name and power limit; float32 matmuls must be full f32
   (no TF32), the reference's ``matmul_precision="highest"``;
2. build: ``nvcc`` for ``sm_90a`` into ``build/kernels/``, one process per
   source, all started together; each kernel function's registers and
   spills from the build log; what the headline ``fused_linear_ey`` call
   launches (blocks, registers, shared memory, blocks/SM, waves); each exact
   tile kernel's dynamic shared memory and resident blocks per SM at M = 12,
   63 and 64, and ``exact_tree_phi``'s by path slot at M = 100;
3. kernel vs plain on the card at the main path's shapes, the edge shapes
   and adversarial sigmoid-form inputs (logits of ±100–200, a background
   range past the factored route's guard, cancelling large logits, N above
   one staged chunk), at groups in several staged slices (M = 17, 48) and
   sigmoid classes on the grid (K = 3, 7, 32), max abs diff <= 1e-5 on
   ``ey``, with how the guard split each sigmoid-form case; softmax (the
   factored kernel) and sigmoid at K = 33, 64, 100 and 257 at a
   headline-like shape, ragged edges and N above one chunk; the general
   softmax's factored kernel on the adversarial kinds and on top classes
   that disagree past its guard (K = 3, 7, 33, 100), and at K = 1000 (u
   formed per class tile), each case with the (b, s, n) triples the guard
   sent to its in-kernel exact route; sigmoid
   past the grid's 65,535 classes must raise; the factored kernel against
   the plain version's time at K = 32, in turns (for the record);
4. main path: ``KernelShap(est.predict_proba, link="logit", seed=0)
   .fit(bg, group_names=..., groups=...).explain(X)`` on an Adult-shaped task
   made from ``--seed`` (B=2560, D=48 in the Adult group widths, N=100), with
   launch counts set to 0 just before and read just after; the answer must be
   additive (< 1e-3, the gate of bench.py), agree with the same explain
   through the kernel's plain version on the card, and with the port on the
   CPU on the first rows;
5. times: explain wall (one warm-up, median of 3), kernel and plain version
   by CUDA events at the headline shape, and the kernel's bound (half a
   reciprocal per activation, two sharing one) beside the floor of its own
   design (one reciprocal) and the unfactored form's (an exp and a
   reciprocal);
6. exact TreeSHAP (``exact_tree_phi``): an Adult-shaped GBT made from
   ``--seed`` (50 trees grown best-first to <= 31 leaves by random splits
   over the 48 columns, leaf values ~N(0, 0.1)) and its packed plan; then
   ``KernelShap(pred).fit(bg, group_names, groups).explain(X,
   nsamples='exact')`` at B=256, N=100, M=12 on the packed route and on the
   dense route, each with launch counts set to 0 just before and read just
   after (one launch per depth bucket, one on the dense route); each answer
   must be additive (< 1e-4), agree with the plain route on the card and
   with the port on the CPU (first 16 rows) within 2e-5·max(1, max|phi|),
   and repeat bit for bit; the exact values must match a brute-force
   Shapley enumeration on 2 rows;
7. ``exact_tree_phi`` against its plain version on the card at the main
   path's bucket inputs and at the edge shapes of ``EXACT_EDGES`` (ragged,
   N=300, dmax=1, M=40 K=3, M=16 K=2, M=24, all live, none live, N=1,
   N=130, M=dmax=63 and M=dmax=64 with every group on path), two launches
   bit-identical, its Beta weights against the f64 table (rtol 5e-5); the
   divergence of each bucket's walk (``divergence``); times: exact explain
   wall at B=256 and B=2560, kernel and plain version by CUDA events per
   bucket, and the kernel's bound;
8. exact Shapley interactions (``exact_tree_inter``): on the same GBT,
   ``explain(X, nsamples='exact', interactions=True)`` at B=256, N=100,
   M=12 with ``pack_paths`` at its auto value (phi packs, so the engine
   rebuilds the dense reach for the pairs), launch counts set to 0 just
   before and read just after: exactly one ``exact_tree_inter`` and one
   dense ``exact_tree_phi`` launch; the matrices must be finite, symmetric
   with rows summing to the shap values (1e-5), agree with the plain route
   on the card and with the port on the CPU (first 16 rows) within
   2e-5·max(1, max|·|), repeat bit for bit, and their off-diagonal entries
   must match half the brute-force Shapley interaction index on 2 rows;
9. ``exact_tree_inter`` against its plain version on the card (atol = rtol
   = 3e-5) at the main path's dense inputs and at the edge shapes of
   ``EXACT_EDGES`` and ``INTER_EDGES`` (the walk by path slot's worst
   cases), two launches bit-identical, its weights against the f64
   table (rtol 5e-5); the divergence of both kernels' walks over the dense
   inputs; the path's dense ``exact_tree_phi`` launch
   against its plain version on the same inputs (2e-5·max(1, max|phi|)),
   bit-identical; times: interaction explain wall at B=256 and B=2560, and
   for each of the two kernels at the dense inputs the kernel and plain
   version by CUDA events and the kernel's bound;
10. packed transfer: the headline engine brings phi, E[f] and f(x) back in
   one device-to-host copy, bit-identical to the explain function's
   outputs copied one by one; with ``transfer_dtype='float16'`` phi stays
   within atol 1e-3 / rtol 2e-3 of the float32 result and E[f], f(x) stay
   bit-identical;
11. l1: the default explain of the 48 one-hot columns ungrouped (M = 48,
   S = 2144, B = 256) runs the 'auto' -> AIC selection, launch counts set
   to 0 just before and read just after (its first pass and its l1 device
   pass launch ``fused_linear_ey``); additive (< 1e-3), and against the
   port on the CPU on the first 32 rows at least 99% of the targets select
   the same set, phi within 1e-3 on them; the wall split into the first
   pass, the l1 device pass with its copy, and the host selection;
12. plan constants with ``use_kernel=False`` at B = 1, 16, 256: the cached
   arm bit-identical to the recomputing arm, both within 1e-5 of the
   classic function (``plan_constant_cache='off'``) and within 1e-3 of
   the kernel route; off for the default engine; walls at B = 1 and 16 of
   the cached, uncached and kernel routes;
13. importance: ``rank_features`` on the headline rows, counted, reduces
   mean |phi| on the device through ``fused_linear_ey``, within
   1e-5·max(1, max|phi|) of the explain's;
14. sampled tree (``adult_trees``): phase 6's GBT with the ``binary_sigmoid``
   head ``HistGradientBoostingClassifier.predict_proba`` lifts to, explained
   by sampling at B=256 (``link='logit'``, default nsamples): launch counts
   set to 0 just before and read just after, and all three must be 0 (the
   path runs no hand kernel: its masked evaluation is the tree's
   ``masked_ey`` in plain PyTorch);
   ``kernel_path['ey'] == 'masked_ey'``, additive (< 1e-3), within 1e-3 of
   the CPU on the first 4 rows; ``masked_ey`` against the row evaluation
   (``_ey_generic``) at B=16 within 1e-5 on ``ey``; the raw-margin tree with
   nsamples=4094 (every coalition of M=12) against ``nsamples='exact'``
   within 1e-4·max(1, max|phi|); times: the wall (one warm-up, median of 3),
   device busy and idle share under ``torch.profiler``, and a CUDA-event
   split of ``masked_ey`` into its tree steps and the rest;
15. MLP (``model_zoo``'s ``sklearn_mlp``): a seeded 48 -> 32 ReLU -> 1 logit
   MLP laid out as the scikit-learn lift lays it out (``mlp_stages`` with
   the ``binary_sigmoid`` head, a ``TorchMLPPredictor``) at B=256 through
   ``masked_ey``, additive, within 1e-3 of the CPU on the first 16 rows; the
   same weights as an ``nn.Sequential`` (lifted, ``masked_ey``) and as a
   module with a skip term (unliftable: a ``TorchPredictor`` on the
   ``'generic'`` route), each within 1e-3 of the first; walls of the three
   at B=256 and 16;
16. black box (``adult_blackbox``): the same MLP as a numpy function in a
   ``CallbackPredictor`` at B=16 with ``EngineConfig(host_eval=True)``
   (``kernel_path`` ``{'ey': 'host', 'host_fill': 'native'}``) and without
   (``'generic'``), both within 1e-3 of phase 15's answer; the host-eval
   ``l1_reg='auto'`` leg on the 48 ungrouped columns, additive; walls with
   ``hosteval_workers`` and ``os.cpu_count()``;
17. chunked (``EngineConfig(instance_chunk=256)``): the headline rows at
   B=2560 in 10 chunks through ``run_pipeline``, launch counts set to 0 just
   before and read just after: exactly 10 ``fused_linear_ey`` launches,
   additive, phi within 1e-4 of phase 4's unchunked answer; the resolved
   window and the device round-trip probe; phase 6's GBT at B=2560 with
   ``nsamples='exact'``, with and without ``interactions=True``, chunked and
   unchunked, each counted (the chunked counts are 10× the unchunked), within
   2e-5·max(1, max|·|) of the unchunked answer; walls of each, chunked and
   unchunked (one warm-up, median of 3);
18. staging: 8 batches of B=16 headline rows, each staged by ``stage_rows``
   (pinned host memory, the engine's side stream, an event) on a batcher
   thread while the one before is dispatched by ``get_explanation_async``
   here and finalized on a pool of 4 threads, counted (8 launches): every
   result bit-identical to ``get_explanation`` on the same rows; one exact
   batch at B=256 the same way; ``stage_rows`` returns None for host eval,
   active l1, interactions and an over-chunk batch; the staged loop's wall
   against 8 synchronous explains;
19. anytime: ``anytime_begin(X).step()`` through the 4 rounds on the
   headline task at B=16 and 256, counted (5 ``fused_linear_ey`` launches a
   run: round 0's enumerated block, then each draw block); every round
   additive (< 1e-3), the reported error monotone, the final round within
   2e-4 of the single-shot WLS over the concatenated rows, within 1e-3 of the
   ``use_kernel=False`` route and of the port on the CPU (first 16 rows);
   a run exported after round 1 and restored on a fresh engine gives rounds
   2–3 bit for bit; the kernel against its plain version (1e-5) on each
   block's own inputs; walls per round, the kernel per block by CUDA events
   beside its bound, and the whole run against the classic explain;
20. profiler and checkpoint: with ``profiler()`` on, one headline explain
   yields ``explain``, ``coalition_plan`` and ``device_explain``, and
   ``trace()`` writes a Chrome trace; ``save`` then ``load`` of the headline
   explainer and of the exact explainer with interactions, each explaining
   bit-identically to its writer;
21. each phase's seconds from 14 on and the script's so far (printed after
   phase 38);
22. boosters: phase 6's GBT written out as an xgboost ``save_raw('json')``
   model (``reg:squarederror``; ``binary:logistic``) and a LightGBM
   ``dump_model()`` dict (``regression``; ``binary``), each behind a
   stand-in estimator and lifted by ``KernelShap(owner.predict)`` (the
   lift's probe included): predictions bit-identical to the seeded
   ensemble's (within 1e-6 for the sigmoid heads); the regression lifts'
   exact explains at B=256 and the xgboost lift's interaction explain,
   counted, equal to the seeded GBT's within 2e-5·max(1, max|·|), each
   kernel against its plain version on these paths' inputs, walls; the
   binary lifts sampled at B=64 through ``masked_ey`` (no hand kernel);
23. affine head: ``AffineOutputPredictor(gbt, 2.5, -1.0)`` exact at B=256,
   counted: phi 2.5 × the bare tree's, E and f(x) through the head, the CPU
   port on the first rows, wall;
24. IsolationForest shape: 100 seeded isolation trees on 64 samples with
   the ``neg_exp2`` head of the ``score_samples`` lift, sampled at B=64 with
   ``link='identity'`` (no hand kernel), additive, the CPU port, the
   ``decision_function`` form (an affine head) with the same phi, wall;
25. tensor train: ``nsamples='exact'`` on ``TensorTrainPredictor`` — the
   reference's mid-size TN (M=24, rank 4, N=32) at B=8 and 256 and an
   Adult-width TN (M=48, rank 16, N=100) at B=256, additive (< 1e-3), the
   CPU port within 1e-4·max(1, max|phi|), no hand kernel; walls, device
   events and busy time under ``torch.profiler``, the DP's f32 FLOP bound
   and its share; a staged explain bit-identical to the synchronous one;
   a TN at M=12 against brute-force enumeration;
26. singular Gram: NaN phi without raising from an indefinite Gram and
   from an all-zero-weight plan; each linear-algebra call of the solve
   timed behind ~2 ms of queued device work, with its reported syncs;
27. the headline explain's WLS host time (``_wls_solve`` wrapped in a host
   clock) over 5 explains, beside the wall;
28. fixture: ``tests/fixtures/adult_parity.npz`` (the JAX package's answers
   on the Adult-schema synthetic rows, made by
   ``scripts/make_adult_parity_fixture.py``): the headline LR on all 2560
   rows against the JAX phi (1e-3 plus 16 f32 ulps of p through the logit
   link, ROADMAP C.9), E and f(x); the ``adult_trees_exact`` GBT's exact
   phi and interactions (256 rows, counted) within 2e-5·max(1, max|·|);
29. pipeline (``config_model_zoo``'s ``scaler_pipeline`` and
   ``grid_search_lr``, at the headline shape B=2560): a
   ``Pipeline(StandardScaler, LogisticRegression)`` stand-in lifts to one
   ``LinearPredictor`` whose W and b equal the numpy float64 fold bit for
   bit; its explain, counted, launches ``fused_linear_ey`` once on the
   kernel path ``'cuda'``; phi against the bare LR explained on pre-scaled
   rows (1e-3 plus 16 p-ulps); a ``GridSearchCV`` stand-in lifts to the same
   W and b; the kernel against its plain version on the pipeline's inputs;
   both walls;
30. SVMs (``svc_rbf``): ``SVC`` stand-ins over 2000 seeded support vectors,
   rbf, linear, poly (degree 3) and sigmoid, explained at B=256 through
   ``masked_ey`` with ``link='identity'``: additive, 0 hand-kernel launches;
   at B=8 ``masked_ey`` against the generic route within 1e-4·max(1,
   max|phi|); the rbf wall, device busy time and the share of its FLOP
   bound (2·S·B·N·V);
31. forwarding ensembles at B=64, ``link='identity'``, counted: soft voting
   (LR, phase 6's GBT as an xgboost stand-in) with weights (0.3, 0.7) takes
   ``masked_ey``, launches ``fused_linear_ey`` once, phi = 0.3·phi_LR +
   0.7·phi_GBT within 1e-4·max(1, max|phi|); ``Pipeline(SimpleImputer,
   GBT)`` forwards the tree's ``masked_ey``, phi bit-identical to the bare
   GBT's; multilabel one-vs-rest over 3 LRs launches the kernel 3 times;
   bagging over 5 LRs on 24-column subsets forwards through select stages
   (5 launches) and agrees with the generic route; each linear member's
   kernel against its plain version;
32. the other families at B=16, each explained once: calibrated sigmoid and
   isotonic over ``LinearSVC`` (3 folds), stacking (LR + GBT → LR with
   passthrough), AdaBoost SAMME over 50 stumps, a transformed-target
   regressor, ``GaussianNB`` and QDA: the lifted class, predictions against
   the stand-in's numpy within 1e-5·max(1, |f|), the route, additivity,
   the walls;
33. compose fixture: ``tests/fixtures/compose_parity.npz`` (made by
   ``scripts/make_compose_parity_fixture.py`` with scikit-learn and the JAX
   package on the Adult-schema rows): a Pipeline(StandardScaler, LR), an
   rbf SVC fitted on 1000 rows, a calibrated isotonic LinearSVC and a
   GaussianNB rebuilt from their fitted attributes; the stand-ins against
   scikit-learn's outputs (1e-9), the lifts against them (1e-5 relative),
   phi on 64 rows against the JAX package's (1e-3, plus 16 p-ulps through
   the logit link);
34. graph ops: each of the 15 ops of ``registry/onnx_lift.py`` at the cases
   of ``tests/test_onnx_lift.py`` evaluated in torch on the card against the
   numpy reference and the port's CPU evaluation (1e-5 × max(1, |y|)); cuDNN
   TF32 must be off at every convolution of the span and of a DeepSHAP
   explain;
35. ONNX linear lowering: the headline LR as a Gemm+Sigmoid ``GraphSpec``
   lifts to a ``LinearPredictor``; its explain at B = 2560, counted, makes
   exactly one ``fused_linear_ey`` launch on path ``'cuda'``, phi within
   1e-4 of phase 4's;
36. DeepSHAP exactness (``benchmarks/deepshap_bench.py`` phase 1): the
   coalition-stable conv net (side 6, M = 9 superpixels) and the additive
   MLP explained with ``nsamples='exact'`` against the port's brute-force
   Shapley enumeration within 1e-4 relative; completeness of a mixed-sign
   BN CNN and a MaxPool CNN;
37. MNIST DeepSHAP (``config_mnist``'s CNN with the trained parameters of
   ``tests/fixtures/deepshap_parity.npz``, logits head, M = 49): B = 2048
   with the mean background (N = 1) and 16 sampled rows, B = 10000 in
   instance chunks of 2048, on synthetic digits made from ``--seed``; each
   counted (no hand kernel), complete (1e-4), cuDNN TF32 off at each
   convolution, walls (median of 3 after one warm-up), device busy, idle
   share, events and the share of the f32 FLOP bound; a staged explain
   bit-identical to the synchronous one; the fixture's 32 images against the
   JAX phi within 1e-4 × max(1, max|phi|);
38. MNIST sampled (``config_mnist``'s own explain): the probs head,
   ``link='logit'``, ``l1_reg=False`` at B = 2048 through the generic route,
   float32 and float16 transfer (``instance_chunk=2048``), additive (1e-3),
   float16 within the packed tolerance of float32, walls against the FLOP
   bound of B·S·N forwards, device busy; the fixture's images against the
   JAX phi within 1e-3 plus 16 p-ulps;
39. serving (``serving/``: the single-process ``ExplainerServer`` over
   HTTP, the port's client): the fixture's LR wrapped by
   ``BatchKernelShapModel.from_explainer``, served with
   ``max_batch_size=64``, a self-calibrated pipeline depth and the warmup
   ladder, staged and then unstaged; all 2560 rows as 256 binary requests
   of 10 rows from 16 workers (16 more on the JSON wire, equal bit for
   bit) against the fixture's JAX phi (1e-4 plus 16 p-ulps) and a direct
   explain; ``fused_linear_ey`` launched exactly once per dispatched batch
   over the request window; walls, rows/s, requests/s, p50/p99 request
   latency, the batches formed, the warmup ladder's seconds; ``/metrics``
   (``dks_compile_total`` with each kernel load, ``dks_serve_warming 0``)
   and ``/statusz``'s memory reconcile against the CUDA allocator; a
   repeated request answered from the result cache with no launch; a
   failing ``fused_linear_ey`` failing its request with a 5xx; the
   fixture's GBT served unpinned (auto-selected exact, ``exact_tree_phi``
   launched per batch) and pinned to interactions (``exact_tree_inter``),
   against ``tree_phi`` / ``tree_interactions``; ``python -m
   distributedkernelshap_tpu_torch.serving.main --checkpoint`` of a
   card-saved explainer answering one request and exiting 0 on SIGTERM;
40. shard journal (``resilience/journal.py``): the fixture LR's explain of
   2560 rows as 10 chunks of 256 through ``run_pipeline`` with a
   ``ShardJournal``, counted: 10 ``fused_linear_ey`` launches, a rerun with
   0 and bit-identical results, a torn last record recomputing that chunk
   only (1 launch), another fingerprint restarting the journal (10), a
   ``crash:site=pool.shard,after=6`` in the thread scope resumed with
   exactly the chunks from 6 on (4); the journal fingerprint of the card's
   engine equal to the CPU engine's; phi against the fixture;
41. multi-tenant gateway (``registry/registry.py``): one
   ``ExplainerServer(registry=ModelRegistry())`` with the fixture LR
   (``lr``), its twin under a second id (``lr_twin``, an equal share key),
   the fixture GBT auto-exact (``gbt``) and pinned to interactions
   (``gbt_inter``, under a ``TenantQuota``): routing by header, JSON field
   and binary wire field, an unknown id's 404 with the roster; a shared
   batch of ``lr`` and ``lr_twin`` as one ``fused_linear_ey`` launch, each
   slot bit-identical to a dedicated dispatch at the same bucket; a mixed
   load from 16 threads (2560 LR rows, 256 exact rows, 64 interaction
   rows) with the launches of each group's dispatches, per-tenant p50/p99
   and rows/s, phi against the fixture; ``lr`` hot-swapped to an LR made
   from ``--seed`` under load (no request lost, each answer from the
   version that admitted it, v1's device caches and ledger bytes gone);
   ``lr_twin`` unregistered (the ledger and ``torch.cuda.memory_allocated``
   fall by its constants); ``gbt_inter`` over its quota answered 429
   ``tenant_rate_limited`` while ``gbt`` is admitted;
42. replica fleet (``serving/replicas.py``): ``ReplicaManager(2,
   factory="chip_smoke:fleet_factory")`` behind its fan-in proxy, both
   workers on card 0, ``DKS_FAULTS`` slowing replica 1's first answers:
   each worker's ``dks_compile_total`` ``cache_hit`` only on the federated
   ``/metrics``; the proxy hedging around the slowed worker; the 2560
   fixture rows as 256 requests of 10 from 16 threads beside phase 39's
   single process (wall, rows/s, requests/s, p50/p99; both replicas
   answer; phi against the fixture); replica 0 SIGKILLed mid-load (only
   its in-flight requests fail, 502 naming it; the supervisor restarts it;
   the seconds until it is routable again); one autoscaler cycle (1 → 2
   replicas on queue pressure, drained back to 1, no request lost); ``python
   -m distributedkernelshap_tpu_torch.serving.main --replica_procs 2``
   healthy, answering and exiting 0 on SIGTERM; after each stop no worker
   process left (``nvidia-smi --query-compute-apps``);
43. the headline on a mesh (``parallel/``: one process, a grid of
   devices): ``KernelShap(..., distributed_opts={'n_devices': <visible
   cards>})`` (1x1) and ``[cuda:0] * n`` at 2x1, 1x2 and 2x2 in slabs of
   256 rows a data shard, each counted: ``fused_linear_ey`` launched
   exactly shards x slabs times (1, 2, 2, 20), additive, phi within 1e-3
   plus 16 p-ulps of phase 4's, the kernel against its plain version on
   every shard's inputs, walls;
44. exact paths on the mesh, the fixture GBT on 256 rows: dense with
   interactions at 1x2 on 99 background rows (one zero-weight pad row:
   2 ``exact_tree_phi`` + 2 ``exact_tree_inter``), packed at 1x2 (the plan
   striped over 2 shards: one launch per local bucket and shard), a
   journaled run at 2x1 in slabs whose replay launches nothing and returns
   the same bits, the mid-size tensor train at 2x1; each within 2e-5 x
   max(1, max|.|) of the single device, each launch against its plain
   version, walls;
45. ``models/cnn.train_mnist_cnn`` on the card: 2000 synthetic digits made
   from ``--seed``, one epoch, accuracy above 0.5 on 200 more; one explain
   of 16 of them over the 49 superpixels through the trained predictor,
   additive; walls;
46. the cross-process mesh (``parallel/mesh.initialize_multihost``): two
   worker processes of this script (``--mp-worker mesh``, files for logs and
   answers) bind ``cuda:0`` and join a gloo group (the card-UUID rule: two
   ranks on one card); they run the headline LR at 2x1 and 1x2 and the
   fixture GBT's dense explain with interactions (99 background rows) and
   packed explain at 1x2, each counted in its own process: each rank
   launches each kernel once per shard it owns (packed: once per local
   bucket), the ranks' phi bit-equal, each layout within phases 43/44's bars
   of the one-process mesh of the same layout, every launch against its
   plain version on the worker's inputs; then one worker at world size 1
   (``--mp-worker nccl``: a card of its own, so NCCL) runs the 1x1 LR,
   bit-equal to phase 4's, and sends it through NCCL all-gathers;
47. a pod (``ReplicaManager(1, pod_processes=2,
   factory="chip_smoke:fleet_factory")``: ``serving.main --coordinator``
   lead and follower on card 0, the ``TCPStore`` wire, pipelined): the
   fixture's 2560 rows as 256 requests of 10 from 16 threads through the
   proxy, phi against the fixture and the direct explain (1e-4 plus 16
   p-ulps); on each member ``fused_linear_ey`` launched once per frame it
   served (its flight recorder's last ``pod_frame`` event at ``/debugz``:
   the lead's server, the follower's health listener); broadcast bytes on
   the lead; the stop's drain handshake with both members exiting 0 within
   30 s and none left on the card; walls, rows/s, p50/p99;
48. the port's gate: ``python3 scripts/torch_lint.py --check`` in a
   subprocess (the concurrency, torch-contract and serving-ladder analyzers
   over every module of the port, the observability drift check with the
   live catalog built on the card, the alert engine's golden replay): exit
   0, no finding, no stale baseline entry, no parse error, the static pass
   under 60 s, every module scanned, nothing of JAX or of the JAX package
   loaded in that process; the report printed;
49. the lock witness: a fresh process of this script (``--mp-worker
   witness``) with ``DKS_LOCK_WITNESS=1`` serves phase 39's fixture LR
   (staged, warmup ladder) and fixture GBT (auto-exact) from two servers
   on the card, 64 requests of 10 rows from 8 threads alternating between
   them, then ``lockwitness.assert_clean(max_hold_s=30)``: no lock-order
   cycle, no hold over 30 s; ``fused_linear_ey`` launched once per LR batch
   dispatched, ``exact_tree_phi`` once per bucket of the GBT's packed plan
   per GBT batch, ``exact_tree_inter`` never; served phi within phase 39's
   bars; acquisitions, lock-order edges, the longest hold and the serving
   wall printed;
50. 100 classes: a seeded 100-class multinomial LR on the Adult-shaped task
   (B = 2560, D = 48 in the Adult groups, N = 100, M = 12, S = 2072,
   ``ey`` 2.1 GB), ``KernelShap(...).fit(...).explain(X)`` with counts set
   to 0 just before and read just after: exactly one ``fused_linear_ey``
   launch (the factored kernel); additive (< 1e-3), phi within 1e-3 +
   16 p-ulps of the plain route on the card and of the CPU port on the
   first 8 rows; the kernel against its plain version on the call's own
   arguments; explain wall, kernel, plain, the factored bound beside the
   earlier count, the kernel's launch info (registers, local memory,
   shared memory, blocks per SM);
51. Covertype (the JAX package's configuration 5, ``benchmarks/configs.py:
   455-509``) with a seeded lookalike: 54 columns in 12 groups (10
   numeric, wilderness 4, soil 40), a 7-class LR, all 581,012 rows with
   ``EngineConfig(instance_chunk=65536)`` and ``transfer_dtype='float16'``,
   counted (one launch per instance chunk, each call printed), then
   ``rank_features``; the first chunk in float32 additive (< 1e-3) and the
   float16 phi within atol 1e-3 / rtol 2e-3 of it; wall, rows/s, the top
   feature, kernel, plain, the factored bound beside the earlier count,
   the kernel's launch info;
52. exact TreeSHAP past 63 groups: a GBT grown as phase 6's over 100
   ungrouped columns explained with ``nsamples='exact'`` at B = 256, N =
   100 on the packed route (one launch per bucket) and the dense route
   (one), and one over 300 columns at B = 64 (dense), each additive (<
   1e-4), within 2e-5·max(1, max|phi|) of the plain route and of the CPU
   on the first 8 rows, and bit-identical over two runs;
   ``exact_tree_phi`` against its plain version at both dense inputs and
   at M in {64, 100, 300} x dmax in {1, 30, 64} with all-live and
   none-live edges, bit-identical repeats, the slot-table kernel equal to
   its plain version at each; dmax = 65 at M = 100 raises; the by-slot
   tile kernel's registers, spills, shared memory and blocks
   per SM at M = 100 and 300; kernel, plain and bound at the dense inputs;
53. exact interactions at M = 64: a GBT over 64 ungrouped columns with
   ``interactions=True`` at B = 64, counted (1 ``exact_tree_inter``, 1
   dense ``exact_tree_phi``), symmetric with rows summing to phi (1e-5),
   within 2e-5·max(1, max|·|) of the plain route and the CPU, bit-identical
   repeats; ``exact_tree_inter`` against its plain version (atol = rtol =
   3e-5) at the dense inputs; M = 65 raises at the wrapper and at the
   explain; the slot walk's registers, spills, shared memory and blocks per
   SM at M = 64 and at M = 32, K = 3; kernel, plain and bound.

The second-to-last line of stdout is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 2 and
prints no result.
"""

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

# Adult (bench.py's task): 4 continuous columns, then one-hot blocks
ADULT_GROUP_NAMES = ['Age', 'Capital Gain', 'Capital Loss', 'Hours per week',
                     'Workclass', 'Education', 'Marital Status', 'Occupation',
                     'Relationship', 'Race', 'Sex', 'Country']
ADULT_WIDTHS = [1, 1, 1, 1, 8, 5, 3, 8, 5, 4, 1, 10]
B_HEADLINE, N_BACKGROUND = 2560, 100

EY_ATOL = 1e-5          # kernel vs plain on ey, the bar of tests/test_pallas.py
ADDITIVITY = 1e-3       # the gate of bench.py
# phi (logit space) of the kernel route vs the plain route, and of the card vs
# the CPU: f32 sums in other orders, amplified by the logit link near
# saturation (d logit = dp / (p (1-p))) and spread by the WLS solve
PHI_ATOL = 1e-3

# published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
SFU_OPS_PER_SM_PER_CLOCK = 16      # special-function unit results per SM per clock
FP32_LANES_PER_SM = 128            # f32 results (adds) per SM per clock
INT32_LANES_PER_SM = 64            # 32-bit integer results per SM per clock

# exact TreeSHAP phase: the Adult GBT's widths (benchmarks/configs.py:240-282)
N_TREES, MAX_LEAVES = 50, 31
GBT_BASE = 0.24         # the seeded ensemble's bias (raw margin)
B_EXACT, B_EXACT_BIG, N_CPU_ROWS = 256, 2560, 16
PHI_REL = 2e-5          # x max(1, max|phi|): tests/test_treeshap.py:780
EXACT_ADDITIVITY = 1e-4
# interactions: the raw pairwise sum, kernel vs plain (atol and rtol), the bar
# of tests/test_treeshap.py:903; symmetry and row sums of the finished
# matrices, tests/test_treeshap.py:518-519
RAW_TOL = 3e-5
CONVENTION_ATOL = 1e-5
# the sampled engine's phases: phi through a float16 transfer against the
# float32 result (tests/test_pipeline.py:316-339); the plan-constant path
# against the classic function; l1 selection on the ungrouped rows (the AIC
# knot array grows as (8p+16)·p·B·K float64, ~0.75 GB at B = 2560, hence
# B = 256), checked on the CPU on the first rows, where at least this share
# of the targets must select the same set
F16_ATOL, F16_RTOL = 1e-3, 2e-3
OFF_ATOL = 1e-5
B_L1, N_L1_CPU, L1_SHARE = 256, 32, 0.99
# the non-linear sampled phases (adult_trees, model_zoo's MLP, adult_blackbox):
# B = 256 as configured; the row-evaluating routes and the black box at 16;
# the CPU checks on the first rows; an exhaustive plan's phi against the
# exact values (the 1e-6 ridge moves phi by ~6e-6 relative at M = 12)
B_TREES, B_SMALL, N_TREE_CPU, N_MLP_CPU = 256, 16, 4, 16
EXACT_SAMPLED_REL = 1e-4
# the serving entry points (phases 17-20): instance chunks of 256 rows
# (10 at the headline), chunked phi against the unchunked; staged batches of
# 16 headline rows, 8 in a row, and one exact batch of 256; anytime runs at
# B = 16 and 256, whose final round is the single-shot WLS over the
# concatenated rows within 2e-4 (tests/test_anytime.py:143) and whose four
# rounds launch fused_linear_ey 5 times (round 0 twice: the enumerated
# block, then the first draw block)
INSTANCE_CHUNK, CHUNK_ATOL = 256, 1e-4
N_STAGED, B_STAGED = 8, 16
ANYTIME_BS, ANYTIME_SINGLE_SHOT, ANYTIME_LAUNCHES = (16, 256), 2e-4, 5
# the seventh slice (phases 22-28): the GBT's binary booster lifts sampled at
# B = 64; an affine head a*f + b; an IsolationForest-shaped ensemble
# (max_samples=64, so its path tensors stay under the path budget) sampled at
# B = 64; the reference's mid-size tensor train (benchmarks/estimator_accuracy
# .py:104-128: M = 24, rank 4, N = 32) at B = 8 and 256 and an Adult-width one
# (M = 48 ungrouped columns, rank 16, N = 100) at B = 256, held to the CPU
# port within TN_REL x max(1, max|phi|), and a TN at M = 12 against
# brute force; the JAX package's answers on the Adult-schema synthetic rows
B_BOOSTER = 64
AFFINE_A, AFFINE_B = 2.5, -1.0
N_IFOREST_TREES, IFOREST_SAMPLES, B_IFOREST = 100, 64, 64
TN_MID, TN_MID_BS, N_TN_CPU = (24, 4, 32), (8, 256), 8
TN_ADULT, B_TN = (48, 16, 100), 256
TN_BRUTE_M, TN_REL = 12, 1e-4
FIXTURE = "tests/fixtures/adult_parity.npz"
LOGIT_ULPS = 16         # f32 ulps of p a logit-space value may move (ROADMAP C.9)
# the eighth slice (phases 29-33): the model zoo of benchmarks/configs.py:293-402
# (config_model_zoo: B = 256 on the Adult task; its svc_rbf fits 5000 rows,
# here N_SV seeded support vectors); the pipeline at the headline shape; the
# forwarding ensembles at B = 64 and the other families at B = 16, since their
# members' trees and the generic route cost what phase 14 measured; the SVM's
# generic-route check at B = 8 (~1e11 FLOP of Gram rows at V = 2000); the
# lifts' predictions against the stand-ins' numpy within ZOO_PRED_REL x max(1,
# |f|), the generic route and the weighted member sum within 1e-4 x max(1,
# max|phi|)
B_ZOO, B_ENSEMBLE, B_FAMILY, B_SVM_GENERIC = 256, 64, 16, 8
N_SV, N_BAG, BAG_FEATURES, N_STUMPS = 2000, 5, 24, 50
VOTING_WEIGHTS = (0.3, 0.7)
ZOO_PRED_REL, SVM_GENERIC_REL, ENSEMBLE_REL = 1e-5, 1e-4, 1e-4
COMPOSE_FIXTURE = "tests/fixtures/compose_parity.npz"
# the ninth slice (phases 34-38): config_mnist (benchmarks/configs.py:404-452):
# 28x28x1 images, the reference CNN with K = 10, M = 49 superpixels of 4x4,
# the mean background of the training images (N = 1; 16 sampled rows for
# the N = 16 run), B = 2048 and 10000 in instance chunks of 2048; the graph
# ops against numpy within GRAPH_REL x max(1, |y|); DeepSHAP exactness and
# completeness within benchmarks/deepshap_bench.py's EXACT_RTOL; the card
# against the JAX package's DeepSHAP phi within DEEP_REL x max(1, max|phi|);
# the ONNX export of the headline LR against the headline explain (its W is
# recovered by probing, so it may differ from the lift's by an f32 rounding)
MNIST_SIDE, MNIST_PATCH, MNIST_CLASSES = 28, 4, 10
B_MNIST, B_MNIST_BIG, MNIST_CHUNK = 2048, 10000, 2048
N_MNIST_TRAIN, N_MNIST_SAMPLE = 4000, 16
GRAPH_REL, EXACT_RTOL, DEEP_REL, ONNX_PHI_ATOL = 1e-5, 1e-4, 1e-4, 1e-4
DEEPSHAP_FIXTURE = "tests/fixtures/deepshap_parity.npz"
# the fifteenth slice (phase 3's wide cases, phases 50-53): the kernels past
# their old limits.  fused_linear_ey at K = 33, 64, 100 and 257 (softmax
# through the factored kernel's class tiles, sigmoid one class a block) at a
# headline-like shape, ragged edges and N above one staged chunk; a
# 100-class multinomial LR on the Adult-shaped task (phase 50, the CPU on
# its first rows); the JAX package's configuration 5, Covertype
# (benchmarks/configs.py:455-509: a 7-class LR over 54 columns in 12 groups,
# all 581,012 rows in 65,536-row instance chunks with a float16 transfer,
# then rank_features; phase 51); exact TreeSHAP of GBTs over 100 and 300
# ungrouped columns (phase 52) and exact interactions over 64 (phase 53),
# each GBT grown as phase 6's
WIDE_EY_KS = (33, 64, 100, 257)
WIDE_EY_SHAPES = (("headline-like", 512, 1024, 100, 12), ("ragged edges", 33, 700, 9, 7),
                  ("N above one chunk", 64, 300, 300, 12))
N_CLASSES_WIDE, N_CLASSES_CPU = 100, 8
COVERTYPE_ROWS, COVERTYPE_CHUNK, COVERTYPE_CLASSES = 581012, 65536, 7
COVERTYPE_WIDTHS = [1] * 10 + [4, 40]       # 10 numeric, wilderness, soil
COVERTYPE_NAMES = [f"num_{i}" for i in range(10)] + ["wilderness", "soil"]
M_WIDE, M_WIDEST, M_INTER_WIDE = 100, 300, 64
B_WIDEST, B_INTER_WIDE, N_WIDE_CPU = 64, 64, 8
WIDE_PHI_EDGES = [(M, dmax, "random") for M in (64, 100, 300) for dmax in (1, 30, 64)] \
    + [(M, 64, kind) for M in (100, 300) for kind in ("all live", "none live")]


def adult_groups():
    groups, start = [], 0
    for w in ADULT_WIDTHS:
        groups.append(list(range(start, start + w)))
        start += w
    return groups


def adult_shaped_rows(rng, n):
    """``n`` rows shaped like the processed Adult data: standardised
    continuous columns, then one-hot categorical blocks (a width-1 block is
    a 0/1 column)."""

    cols = []
    for w in ADULT_WIDTHS:
        if len(cols) < 4:
            cols.append(rng.normal(size=(n, 1)))
        elif w == 1:
            cols.append(rng.integers(0, 2, size=(n, 1)).astype(np.float64))
        else:
            cols.append(np.eye(w)[rng.integers(0, w, size=n)])
    return np.concatenate(cols, axis=1).astype(np.float32)


class AdultShapedLogisticRegression:
    """A binary logistic regression with scikit-learn's attributes
    (``coef_ (1, 48)``, ``intercept_ (1,)``) and a numpy ``predict_proba``,
    with logits of the range the repo's fitted Adult model gives."""

    def __init__(self, rng):
        self.coef_ = rng.normal(scale=0.75, size=(1, sum(ADULT_WIDTHS)))
        self.intercept_ = np.array([-1.25])

    @classmethod
    def fitted(cls, coef, intercept):
        """The model with given ``coef_`` and ``intercept_``."""

        est = cls.__new__(cls)
        est.coef_ = np.asarray(coef, np.float64)
        est.intercept_ = np.asarray(intercept, np.float64)
        return est

    def predict_proba(self, X):
        z = np.asarray(X, dtype=np.float64) @ self.coef_.T + self.intercept_
        p = 1.0 / (1.0 + np.exp(-z))
        return np.hstack([1.0 - p, p])


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def group_space_inputs(rng, B, S, N, M, K, device, mask=None):
    """Random ``fused_linear_ey`` inputs as ``_ey_linear`` forms them: two
    columns per group, logits of O(1)."""

    import torch

    D = 2 * M
    X = rng.normal(size=(B, D))
    bg = rng.normal(size=(N, D))
    W = rng.normal(scale=0.7, size=(D, K))
    b = rng.normal(size=K)
    G = np.zeros((M, D))
    for m in range(M):
        G[m, 2 * m:2 * m + 2] = 1.0
    if mask is None:
        mask = (rng.random(size=(S, M)) < 0.5).astype(np.float32)
    GW = G[:, :, None] * W[None]
    arrays = (np.einsum("bd,mdk->bmk", X, GW), np.einsum("nd,mdk->nmk", bg, GW),
              bg @ W + b, rng.random(N) + 0.5, mask)
    return [torch.tensor(np.asarray(a, dtype=np.float32), device=device) for a in arrays]


#: kinds of adversarial sigmoid-form inputs (:func:`adversarial_ey_inputs`)
EY_ADVERSARIAL = ("large logits", "spread past the guard", "cancelling")
#: kinds of adversarial general-softmax inputs: the sigmoid form's, and top
#: classes that disagree so far that the factored D underflows
EY_SOFTMAX_ADVERSARIAL = EY_ADVERSARIAL + ("top classes apart",)
#: general-softmax class counts phase 3 gives each adversarial kind
EY_SOFTMAX_ADVERSARIAL_KS = (3, 7, 16, 33, 100)


def _quantised(a):
    """``a`` on a 2^-10 grid: the group sums of such values (|sum| < 2^14)
    are exact in float32 in any order, so the kernel and its plain version
    see the same logits and differ only in the activation's arithmetic."""

    return (np.round(np.asarray(a) * 1024.0) / 1024.0).astype(np.float32)


def adversarial_ey_inputs(rng, kind, B, S, N, M, K, activation, device):
    """``fused_linear_ey`` inputs that press on the sigmoid-form branches'
    factored arithmetic (``csrc/fused_linear_ey.cu``, head comment), each
    class's logits drawn per ``kind``:

    - ``"large logits"``: instance group logits of ±8–17 (a sign per row)
      and background terms t' of ±(100–200) with a range of about 60 over
      the background: |dp| and |t'| reach 100–200 and |dp − shift| passes
      the clamp;
    - ``"spread past the guard"``: groups 6.. with background logits of
      N(0, 40), groups ..5 of N(0, 1); every fourth coalition holds only
      groups ..5 (so its range stays inside the guard) and the rest are
      random (so most pass it): both routes in one warp;
    - ``"cancelling"``: instance and background group logits both c_m ±
      N(0, 0.3) with c_m of 20–30 (one sign per class): dp and t' of up
      to ±360 that cancel to x of O(1);
    - ``"top classes apart"`` (for the general softmax): every group adds
      25 to instance b's class b mod K and to background row n's class
      (n + 1) mod K of -t', over N(0, 0.3) noise: where the two disagree
      and the coalition holds three groups or more, the factored D =
      Σ_k u·v falls below the kernel's guard (e^-75 and less) while the
      softmax itself is an even split.

    Binary softmax carries the designed logit in class 1 (class 0 is 0);
    sigmoid and the general softmax design every class.  Values sit on the :func:`_quantised`
    grid; background weights are U(0.5, 1.5)."""

    import torch

    A = np.zeros((B, M, K))
    G = np.zeros((N, M, K))
    Wn = np.zeros((N, K))
    mask = (rng.random((S, M)) < 0.5).astype(np.float32)
    classes = [1] if activation == "softmax" and K == 2 else range(K)
    for k in classes:
        if kind == "large logits":
            c = rng.uniform(-17, 17, M)
            A[:, :, k] = rng.choice([-1.0, 1.0], (B, 1)) * rng.uniform(8, 17, (B, M))
            G[:, :, k] = c + rng.normal(0, 0.4, (N, M))
            Wn[:, k] = rng.choice([-1.0, 1.0]) * rng.uniform(100, 150) + rng.uniform(-30, 30, N)
        elif kind == "spread past the guard":
            A[:, :, k] = rng.normal(0, 10, (B, M))
            G[:, :, k] = rng.normal(0, 1, (N, M))
            G[:, M // 2:, k] = rng.normal(0, 40, (N, M - M // 2))
            Wn[:, k] = rng.normal(0, 5, N)
        elif kind == "cancelling":
            c = rng.choice([-1.0, 1.0]) * rng.uniform(20, 30, M)
            A[:, :, k] = c + rng.normal(0, 0.3, (B, M))
            G[:, :, k] = c + rng.normal(0, 0.3, (N, M))
            Wn[:, k] = rng.normal(0, 1, N)
        elif kind == "top classes apart":
            A[:, :, k] = rng.normal(0, 0.3, (B, M)) + 25.0 * (np.arange(B) % K == k)[:, None]
            G[:, :, k] = rng.normal(0, 0.3, (N, M)) \
                - 25.0 * ((np.arange(N) + 1) % K == k)[:, None]
            Wn[:, k] = rng.normal(0, 0.3, N)
        else:
            raise ValueError(f"unknown kind {kind!r}")
    if kind == "spread past the guard":
        mask[::4, M // 2:] = 0.0
    arrays = (_quantised(A), _quantised(G), _quantised(Wn),
              (rng.random(N) + 0.5).astype(np.float32), mask)
    return [torch.tensor(a, device=device) for a in arrays]


def ey_guard_stats(args, activation, chunk_rows):
    """How the sigmoid-form kernel's guard splits these inputs, counted with
    the plain version's logits: of the (class, coalition, background chunk)
    columns, those whose t' range passes the guard's spread (the exact
    loop), and of the (instance, coalition, class, chunk) rows on the
    factored route, those whose ``|dp − shift|`` passes its clamp (both
    read from the source, ``cuda_kernels.ey_guard_constants``).
    ``chunk_rows`` is the kernel's background rows per chunk."""

    import torch

    from distributedkernelshap_tpu_torch.ops.cuda_kernels import ey_guard_constants

    guard = ey_guard_constants()
    XWg, bgWg, bgW, _, mask = args
    if activation == "softmax" and XWg.shape[2] == 2:
        XWg, bgWg, bgW = (t[..., 1:] - t[..., :1] for t in (XWg, bgWg, bgW))
    dp = torch.einsum("sm,bmk->bsk", mask, XWg)
    tp = torch.einsum("sm,nmk->snk", mask, bgWg) - bgW[None]
    out = {"columns": 0, "exact_route": 0, "rows": 0, "rows_clamped": 0}
    for n0 in range(0, tp.shape[1], chunk_rows):
        t = tp[:, n0:n0 + chunk_rows]
        lo, hi = t.min(1).values, t.max(1).values        # (S, K)
        factored = (hi - lo) <= guard["spread"]
        shift = 0.5 * (lo + hi)
        out["columns"] += factored.numel()
        out["exact_route"] += int((~factored).sum())
        rows = factored[None].expand_as(dp)
        out["rows"] += int(rows.sum())
        out["rows_clamped"] += int(((dp - shift[None]).abs() > guard["clamp"])[rows].sum())
    return out


def softmax_guard_stats(args):
    """How the factored general softmax's guard splits these inputs,
    counted in float32 with the kernel's steps (``csrc/fused_linear_ey.cu``,
    head comment): ``u = exp(p1 − max_k p1)``, ``v = exp(−t' − max_k −t')``
    (a row of zeros where a t' is not finite), ``D = Σ_k u·v``; of the ``(b, s,
    n)`` triples, those with D below ``kTau`` or NaN, which the kernel
    computes exactly (``cuda_kernels.ey_softmax_tau``)."""

    import torch

    from distributedkernelshap_tpu_torch.ops.cuda_kernels import ey_softmax_tau

    XWg, bgWg, bgW, _, mask = args
    p1 = torch.einsum("sm,bmk->bsk", mask, XWg)
    tp = torch.einsum("sm,nmk->snk", mask, bgWg) - bgW[None]
    u = torch.exp(p1 - p1.nan_to_num(nan=-float("inf")).amax(-1, keepdim=True))
    v = torch.exp(-tp - (-tp).nan_to_num(nan=-float("inf")).amax(-1, keepdim=True))
    v = torch.where(tp.isfinite().all(-1, keepdim=True), v, 0.0)
    D = torch.einsum("bsk,snk->bsn", u, v)
    return {"triples": D.numel(), "exact_route": int((~(D >= ey_softmax_tau())).sum())}


# ---------------------------------------------------------------------- #
# the tenth slice (phase 39): the single-process explanation server


#: phase 39's LR traffic: the fixture's 2560 rows as requests of this many
#: rows, sent by this many client workers; the server's batch cap in
#: requests
SERVE_ROWS_PER_REQUEST, SERVE_WORKERS, SERVE_MAX_BATCH = 10, 16, 64
#: fixture rows the LR deployment serves (all of them)
SERVE_N_ROWS = 2560
#: phase 39's GBT traffic: exact rows served (the fixture's tree_phi has
#: 256) and pinned-interactions rows, in requests of this many rows
SERVE_TREE_ROWS, SERVE_INTER_ROWS, SERVE_TREE_REQUEST = 256, 64, 8


def adult_fixture():
    """The committed fixture as a dict, with its Adult grouping."""

    import os

    fx = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), FIXTURE),
                 allow_pickle=False)
    out = {k: fx[k] for k in fx.files}
    widths = [int(w) for w in out["group_widths"]]
    starts = np.concatenate([[0], np.cumsum(widths)[:-1]])
    out["groups"] = [list(range(s, s + w)) for s, w in zip(starts, widths)]
    out["names"] = [f"g{i}" for i in range(len(widths))]
    return out


def _http_get(url, timeout=30.0):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _wait_healthy(srv, budget_s=120.0):
    """Poll ``/healthz`` until it answers 200; returns the seconds waited."""

    t0 = time.perf_counter()
    while True:
        code, body = _http_get(f"http://127.0.0.1:{srv.port}/healthz")
        if code == 200:
            return time.perf_counter() - t0
        if time.perf_counter() - t0 > budget_s:
            raise AssertionError(f"/healthz never answered 200 (last {code}: {body})")
        time.sleep(0.02)


def _metric_value(srv, name, **labels):
    m = srv.metrics.get(name)
    return float(m.value(**labels)) if m is not None else 0.0


class _BatchLog:
    """Wraps a serving model's ``explain_batch_async``: while ``on``, logs
    each dispatched batch's request count, rows and whether its rows came
    staged (an engine ``StagedRows``, not a host array)."""

    def __init__(self, model):
        self.on, self.batches = False, []
        inner = model.explain_batch_async

        def logged(instances, split_sizes=None, **kw):
            if self.on:
                sizes = list(split_sizes or [])
                self.batches.append((len(sizes), int(sum(sizes)),
                                     not isinstance(instances, np.ndarray)))
            return inner(instances, split_sizes=split_sizes, **kw)

        model.explain_batch_async = logged


def _serve_lr_traffic(model, log, X, staging, card):
    """One LR server (the reference's defaults: self-calibrated depth, the
    warmup ladder) answering ``X`` as requests of
    ``SERVE_ROWS_PER_REQUEST`` rows from ``SERVE_WORKERS`` workers on the
    binary wire, counted over the request window only."""

    import torch
    from distributedkernelshap_tpu_torch.serving import client as cl
    from distributedkernelshap_tpu_torch.serving.server import ExplainerServer

    t0 = time.perf_counter()
    srv = ExplainerServer(model, host="127.0.0.1", port=0, max_batch_size=SERVE_MAX_BATCH,
                          warmup=True, staging=staging).start()
    try:
        start_s = time.perf_counter() - t0
        healthy_s = _wait_healthy(srv)
        warm = srv.warmup_status()
        url = f"http://127.0.0.1:{srv.port}/explain"
        requests = np.split(X, X.shape[0] // SERVE_ROWS_PER_REQUEST)
        latencies = []
        inner = cl.explain_request

        def timed(*a, **kw):
            t = time.perf_counter()
            out = inner(*a, **kw)
            latencies.append(time.perf_counter() - t)
            return out

        batches0 = _metric_value(srv, "dks_serve_batches_total")
        log.batches.clear()
        reset_launches()
        log.on = True
        cl.explain_request = timed
        try:
            t = time.perf_counter()
            payloads = cl.distribute_requests(url, X, batch_mode="default",
                                              minibatches=requests,
                                              max_workers=SERVE_WORKERS,
                                              wire_format="binary")
            wall = time.perf_counter() - t
        finally:
            cl.explain_request = inner
            log.on = False
        torch.cuda.synchronize()
        launches = kernel_launches()
        batches = int(_metric_value(srv, "dks_serve_batches_total") - batches0)
        staged_ok = sum(s for _, _, s in log.batches)
        json_payloads = cl.distribute_requests(url, X[:16 * SERVE_ROWS_PER_REQUEST],
                                               batch_mode="default",
                                               minibatches=requests[:16],
                                               max_workers=SERVE_WORKERS, wire_format="json")
        code, metrics = _http_get(f"http://127.0.0.1:{srv.port}/metrics")
        code_s, statusz = _http_get(f"http://127.0.0.1:{srv.port}/statusz?format=json")
    finally:
        srv.stop()
    lat = np.sort(np.asarray(latencies)) * 1e3
    req_per_batch = [n for n, _, _ in log.batches]
    rows_per_batch = [r for _, r, _ in log.batches]
    rec = {
        "payloads": payloads, "json_payloads": json_payloads, "wall": wall,
        "p50": float(np.percentile(lat, 50)), "p99": float(np.percentile(lat, 99)),
        "launches": launches, "batches": batches, "logged": len(log.batches),
        "depth": srv.pipeline_depth, "metrics": metrics, "statusz": (code_s, statusz),
        "warm": warm, "start_s": start_s, "healthy_s": healthy_s, "staged": staged_ok,
    }
    print(f"serving LR ({'staged' if staging else 'unstaged'}): start {start_s:.3f} s "
          f"(calibrated pipeline_depth {srv.pipeline_depth}), warmup ladder buckets "
          f"{warm['buckets']} state {warm['state']} in {warm['elapsed_s']:.3f} s, /healthz 200 "
          f"after {healthy_s:.3f} s; {X.shape[0]} rows as {len(requests)} binary requests of "
          f"{SERVE_ROWS_PER_REQUEST} from {SERVE_WORKERS} workers: wall {1e3 * wall:.3f} ms, "
          f"{X.shape[0] / wall:.1f} rows/s, {len(requests) / wall:.1f} requests/s; request "
          f"latency p50 {np.percentile(lat, 50):.3f} ms, p99 {np.percentile(lat, 99):.3f} ms, "
          f"max {lat.max():.3f} ms; {batches} batches (requests per batch min/median/max "
          f"{min(req_per_batch)}/{int(np.median(req_per_batch))}/{max(req_per_batch)}, rows "
          f"{min(rows_per_batch)}/{int(np.median(rows_per_batch))}/{max(rows_per_batch)}); "
          f"launches over the window {launches}"
          + f"; staged batches {staged_ok}" + f" on {card}",
          flush=True)
    return rec


def serving_phase(explain_device, card):
    """Phase 39: the port's single-process ``ExplainerServer`` on the card,
    at the fixture's Adult width, driven over HTTP through the port's
    client; returns ``{kernel: launches}`` of the served traffic."""

    import os
    import signal
    import socket
    import tempfile

    import torch
    from distributedkernelshap_tpu_torch import KernelShap, TreeEnsemblePredictor
    from distributedkernelshap_tpu_torch.ops import explain as texp
    from distributedkernelshap_tpu_torch.runtime.compile_cache import compile_events
    from distributedkernelshap_tpu_torch.serving import client as cl
    from distributedkernelshap_tpu_torch.serving.server import ExplainerServer
    from distributedkernelshap_tpu_torch.serving.wrappers import BatchKernelShapModel

    device = explain_device
    fx = adult_fixture()
    X, bg = fx["X"][:SERVE_N_ROWS], fx["background"]
    est = AdultShapedLogisticRegression.fitted(fx["coef"], fx["intercept"])
    ks = KernelShap(est.predict_proba, link="logit", seed=0, device=device)
    ks.fit(bg, group_names=fx["names"], groups=fx["groups"])
    serving_launches = {}
    ulp = 2.0 ** -24 * (2.0 + 2.0 * np.cosh(fx["raw_prediction"][:SERVE_N_ROWS, 1]))

    # -- the LR deployment: staged, then unstaged ----------------------- #
    direct = np.stack(ks.explain(X, silent=True).shap_values, 1)
    walls = {}
    for staging in (True, False):
        model = BatchKernelShapModel.from_explainer(ks)
        log = _BatchLog(model)
        rec = _serve_lr_traffic(model, log, X, staging, card)
        walls["staged" if staging else "unstaged"] = rec["wall"]
        phi = np.concatenate([np.stack(p["shap_values"], 1) for p in rec["payloads"]])
        d_fix = np.abs(phi - fx["phi"][:SERVE_N_ROWS]).max((1, 2))
        fix_ok = d_fix <= 1e-4 + LOGIT_ULPS * ulp
        d_direct = float(np.abs(phi - direct).max())
        phi_json = np.concatenate([np.stack(p["data"]["shap_values"], 1) for p in
                                   map(json.loads, rec["json_payloads"])])
        n_json = phi_json.shape[0]
        d_json = float(np.abs(phi_json - phi[:n_json]).max())
        json_ok = (np.abs(phi_json - fx["phi"][:n_json]).max((1, 2))
                   <= 1e-4 + LOGIT_ULPS * ulp[:n_json]).all()
        print(f"serving LR ({'staged' if staging else 'unstaged'}) answers: |phi served - "
              f"phi JAX fixture| max {d_fix.max():.3e} (tol 1e-4 + {LOGIT_ULPS} p-ulps; "
              f"{int((d_fix <= 1e-4).sum())}/{X.shape[0]} rows within 1e-4 alone); |phi "
              f"served - direct explain of the same rows on the card| {d_direct:.3e} "
              f"({'bit-identical' if d_direct == 0.0 else 'not bit-identical'}); the JSON "
              f"wire's {n_json} rows vs the binary wire's {d_json:.3e} (other batches; "
              f"within the fixture's bar: {json_ok}); fused_linear_ey launches {rec['launches']['fused_linear_ey']}"
              f" vs {rec['batches']} batches counted by the server ({rec['logged']} "
              f"dispatches logged)", flush=True)
        if not fix_ok.all() or not json_ok or d_direct > PHI_ATOL \
                or rec["launches"]["fused_linear_ey"] != rec["batches"] \
                or rec["logged"] != rec["batches"] or rec["batches"] < 1 \
                or rec["launches"]["exact_tree_phi"] or rec["launches"]["exact_tree_inter"]:
            raise AssertionError("the served LR deployment is off")
        if bool(rec["staged"]) != staging:
            raise AssertionError("the server's staging is not what was asked for")
        if staging:
            serving_launches["fused_linear_ey"] = rec["launches"]["fused_linear_ey"]
            serving_launches["single"] = {k: rec[k] for k in ("wall", "p50", "p99")}
            first = rec
    print(f"serving LR walls: staged {1e3 * walls['staged']:.3f} ms, unstaged "
          f"{1e3 * walls['unstaged']:.3f} ms on {card}", flush=True)

    # -- server surfaces of the staged run ------------------------------ #
    metrics = first["metrics"]
    compile_lines = [ln for ln in metrics.splitlines() if ln.startswith("dks_compile_total{")]
    artefacts = compile_events().artefacts()
    code_s, statusz = first["statusz"]
    memory = json.loads(statusz)["detail"]["memory"]
    rec_mem = memory["reconcile"]
    allocated = int(torch.cuda.memory_stats(device)["allocated_bytes.all.current"])
    print(f"serving surfaces: dks_compile_total {compile_lines}; artefacts {artefacts}; "
          f"'dks_serve_warming 0' on /metrics: {'dks_serve_warming 0' in metrics}; /statusz "
          f"{code_s} memory reconcile {rec_mem} (allocator now {allocated} bytes), ledger "
          f"owners {memory['owners']}", flush=True)
    if not compile_lines or not {"fused_linear_ey", "exact_tree_phi",
                                 "exact_tree_inter"} <= set(artefacts) \
            or "dks_serve_warming 0" not in metrics or code_s != 200 \
            or rec_mem.get("supported") is not True or not rec_mem.get("bytes_in_use"):
        raise AssertionError("a server surface is off")

    # -- the result cache: a repeat costs no launch --------------------- #
    srv = ExplainerServer(BatchKernelShapModel.from_explainer(ks), host="127.0.0.1", port=0,
                          max_batch_size=SERVE_MAX_BATCH, pipeline_depth=4, warmup=False,
                          cache_bytes=1 << 22).start()
    try:
        url = f"http://127.0.0.1:{srv.port}/explain"
        one = cl.explain_request(url, X[:SERVE_ROWS_PER_REQUEST])
        torch.cuda.synchronize()
        reset_launches()
        again = cl.explain_request(url, X[:SERVE_ROWS_PER_REQUEST])
        torch.cuda.synchronize()
        cache_launches = kernel_launches()
        hits = _metric_value(srv, "dks_serve_cache_hits_total")
        weak = _metric_value(srv, "dks_result_cache_weak_fingerprint_total")
    finally:
        srv.stop()
    print(f"serving result cache: repeat identical {again == one}, launches {cache_launches}, "
          f"cache hits {hits:.0f}, weak (in-process identity) model fingerprints {weak:.0f} "
          f"(the LR's CUDA buffers hashed by content)", flush=True)
    if again != one or any(cache_launches.values()) or hits < 1 or weak:
        raise AssertionError("the repeated request was not answered from the result cache")

    # -- no fallback: a failing kernel fails the request ---------------- #
    srv = ExplainerServer(BatchKernelShapModel.from_explainer(ks), host="127.0.0.1", port=0,
                          max_batch_size=4, pipeline_depth=2, warmup=False).start()
    real = texp.fused_linear_ey

    def failing(*a, **kw):
        raise RuntimeError("fused_linear_ey launch failed (injected)")

    texp.fused_linear_ey = failing
    try:
        import urllib.error
        import urllib.request

        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/explain",
            data=json.dumps({"array": X[:2].tolist()}).encode(),
            headers={"Content-Type": "application/json"})
        try:
            urllib.request.urlopen(req, timeout=60)
            status = 200
        except urllib.error.HTTPError as e:
            status = e.code
    finally:
        texp.fused_linear_ey = real
        srv.stop()
    print(f"serving with a failing fused_linear_ey: HTTP {status} (want 5xx)", flush=True)
    if status < 500:
        raise AssertionError("a failing kernel did not fail the request")

    # -- the GBT deployments --------------------------------------------- #
    tree = TreeEnsemblePredictor(
        fx["tree_feature"], fx["tree_threshold"], fx["tree_left"], fx["tree_right"],
        fx["tree_value"], depth=int(fx["tree_depth"]), aggregation="sum",
        base=fx["tree_base"], scale=float(fx["tree_scale"]),
        missing_left=fx["tree_missing_left"], vector_out=False, device=device)
    tks = KernelShap(tree, task="regression", seed=0, device=device)
    tks.fit(bg, group_names=fx["names"], groups=fx["groups"])
    reset_launches()
    tks.explain(X[:SERVE_TREE_REQUEST], nsamples="exact", silent=True)
    torch.cuda.synchronize()
    per_explain = kernel_launches()["exact_tree_phi"]
    for pinned in (False, True):
        kw = {"nsamples": "exact", "interactions": True} if pinned else None
        model = BatchKernelShapModel.from_explainer(tks, explain_kwargs=kw)
        srv = ExplainerServer(model, host="127.0.0.1", port=0, max_batch_size=SERVE_MAX_BATCH,
                              pipeline_depth=4, warmup=False).start()
        try:
            url = f"http://127.0.0.1:{srv.port}/explain"
            rows = X[:SERVE_INTER_ROWS if pinned else SERVE_TREE_ROWS]
            path0 = _metric_value(srv, "dks_serve_explain_path_total", path="exact")
            batches0 = _metric_value(srv, "dks_serve_batches_total")
            reset_launches()
            t = time.perf_counter()
            payloads = cl.distribute_requests(
                url, rows, batch_mode="default",
                minibatches=np.split(rows, rows.shape[0] // SERVE_TREE_REQUEST),
                max_workers=SERVE_WORKERS, wire_format="binary")
            wall = time.perf_counter() - t
            torch.cuda.synchronize()
            launches = kernel_launches()
            batches = int(_metric_value(srv, "dks_serve_batches_total") - batches0)
            path_n = _metric_value(srv, "dks_serve_explain_path_total", path="exact") - path0
        finally:
            srv.stop()
        phi = np.concatenate([p["shap_values"][0] for p in payloads])
        d_phi = rel_close(phi, fx["tree_phi"][:rows.shape[0]])
        d_inter = None
        if pinned:
            inter = np.concatenate([p["interaction_values"][0] for p in payloads])
            d_inter = rel_close(inter, fx["tree_interactions"][:rows.shape[0]])
            want = {"exact_tree_inter": batches, "exact_tree_phi": batches}
        else:
            want = {"exact_tree_phi": per_explain * batches}
        print(f"serving GBT ({'pinned interactions' if pinned else 'unpinned'}): path "
              f"{model.explain_path} ({model.explain_path_reason}), "
              f"dks_serve_explain_path_total{{path=\"exact\"}} +{path_n:.0f} (requests); "
              f"{rows.shape[0]} "
              f"rows in {len(payloads)} requests, wall {1e3 * wall:.3f} ms, {batches} batches, "
              f"launches {launches} (want {want}); |phi - tree_phi JAX| {d_phi:.3e}"
              + (f", |inter - tree_interactions JAX| {d_inter:.3e}" if pinned else "")
              + f" (tol {PHI_REL:g} x max(1, max|.|)) on {card}", flush=True)
        if model.explain_path != "exact" or path_n != len(payloads) or batches < 1 \
                or any(launches[k] != v for k, v in want.items()) \
                or launches["fused_linear_ey"] \
                or (not pinned and (launches["exact_tree_inter"]
                                    or model.explain_path_reason != "auto")):
            raise AssertionError("a served GBT deployment is off")
        for k in want:
            serving_launches[k] = serving_launches.get(k, 0) + launches[k]

    # -- the CLI entry point --------------------------------------------- #
    lifted = ks._explainer.predictor
    cks = KernelShap(lifted, link="logit", seed=0, device=device)
    cks.fit(bg, group_names=fx["names"], groups=fx["groups"])
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "lr.pkl")
        cks.save(ckpt)
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "distributedkernelshap_tpu_torch.serving.main",
             "--checkpoint", ckpt, "--host", "127.0.0.1", "--port", str(port),
             "--pipeline_depth", "2", "--max_batch_size", "8"],
            cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT)
        try:
            while True:
                try:
                    code, _ = _http_get(f"http://127.0.0.1:{port}/healthz", timeout=5)
                except OSError:
                    code = None
                if code == 200:
                    break
                if proc.poll() is not None or time.perf_counter() - t0 > 180:
                    raise AssertionError("the CLI server never became healthy: "
                                         + proc.stdout.read().decode()[-2000:])
                time.sleep(0.1)
            up_s = time.perf_counter() - t0
            body = cl.explain_request(f"http://127.0.0.1:{port}/explain", X[:2],
                                      wire_format="binary")
            d_cli = float(np.abs(np.stack(body["shap_values"], 1) - direct[:2]).max())
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    print(f"serving CLI (serving.main --checkpoint, saved on {device}): healthy after "
          f"{up_s:.3f} s, |phi - direct| {d_cli:.3e}, exit {rc} on SIGTERM", flush=True)
    if rc != 0 or d_cli > PHI_ATOL:
        raise AssertionError("the CLI server is off")
    return serving_launches


# ---------------------------------------------------------------------- #
# the eleventh slice (phases 40-42): the shard journal, the multi-tenant
# gateway and the replica fleet on one card


#: phase 40: the fixture LR's chunked explain, this many chunks of this
#: many rows, and the hit after which the injected pool.shard crash fires
JOURNAL_CHUNKS, JOURNAL_ROWS, JOURNAL_CRASH_AFTER = 10, 256, 6
#: phase 41's traffic: the LR rows split between the two LR tenants, the
#: GBT rows (auto-exact) and the pinned-interactions rows, in requests of
#: SERVE_ROWS_PER_REQUEST (LR) and SERVE_TREE_REQUEST (GBT) rows
GATEWAY_LR_ROWS, GATEWAY_TREE_ROWS, GATEWAY_INTER_ROWS = 2560, 256, 64
#: the hot swap starts after this many answers and the load ends this many
#: requests after the swap returned
SWAP_AFTER = 64
#: phase 42: the fault that slows replica 1 (its first FLEET_SLOW_TIMES
#: answers, FLEET_SLOW_S each), the hedge delay, the requests of the hedge
#: step, and the autoscaler fleet's batch cap and client threads
FLEET_SLOW_S, FLEET_SLOW_TIMES, FLEET_HEDGE_S, FLEET_HEDGE_REQUESTS = 1.0, 4, 0.25, 8
SCALE_MAX_BATCH, SCALE_CLIENTS = 2, 32
#: the twelfth slice (phases 43-45): the headline on the mesh, laid out
#: ``(label, devices, coalition_parallel, batch_size)``: ``KernelShap(
#: distributed_opts={'n_devices': <visible cards>})`` (1x1), then
#: ``[cuda:0] * n`` at 2x1, 1x2 and 2x2 in slabs of MESH_BATCH rows a data
#: shard; the fixture GBT's exact rows on the mesh, its dense interactions
#: on a background of MESH_BG_ODD rows (padded by one zero-weight row at
#: 1x2), its journaled run in slabs of MESH_JOURNAL_BATCH rows a data shard;
#: the reference's mid-size tensor train at 2x1; train_mnist_cnn for one
#: epoch on CNN_TRAIN synthetic digits, above CNN_MIN_ACC on CNN_TEST more,
#: then one explain of B_CNN_EXPLAIN of them
MESH_LAYOUTS = (("1x1", None, 1, None), ("2x1", 2, 1, None), ("1x2", 2, 2, None),
                ("2x2 slabs", 4, 2, 256))
MESH_EXACT_ROWS, MESH_BG_ODD, MESH_JOURNAL_BATCH = 256, 99, 64
CNN_TRAIN, CNN_TEST, CNN_BATCH, CNN_MIN_ACC, B_CNN_EXPLAIN = 2000, 200, 128, 0.5, 16
REPO_ROOT = os.path.dirname(os.path.abspath(__file__))


def fixture_lr_explainer(fx, device):
    """The fixture's LR (the JAX package's ``coef`` / ``intercept``) lifted
    and fitted on the fixture background with its Adult grouping."""

    from distributedkernelshap_tpu_torch import KernelShap

    est = AdultShapedLogisticRegression.fitted(fx["coef"], fx["intercept"])
    ks = KernelShap(est.predict_proba, link="logit", seed=0, device=device)
    ks.fit(fx["background"], group_names=fx["names"], groups=fx["groups"])
    return ks


def _fleet_deployment(device):
    """The fixture LR as a ``LinearPredictor`` (the two-class softmax the
    lift makes) with the fixture background and grouping, as a replica
    worker's ``(predictor, background, ctor_kwargs, fit_kwargs)``."""

    from distributedkernelshap_tpu_torch.models.predictors import LinearPredictor

    fx = adult_fixture()
    coef = np.asarray(fx["coef"], np.float32).reshape(-1)
    W = np.stack([np.zeros_like(coef), coef], 1)
    b = np.array([0.0, float(np.asarray(fx["intercept"]).reshape(-1)[0])], np.float32)
    return (LinearPredictor(W, b, "softmax", device=device), fx["background"],
            {"link": "logit", "seed": 0, "device": device},
            {"group_names": fx["names"], "groups": fx["groups"]})


def fleet_factory():
    """Phase 42's replica deployment on the card (``chip_smoke:fleet_factory``)."""

    return _fleet_deployment("cuda")


def fleet_factory_cpu():
    """The same deployment on the CPU (the CPU tests' workers)."""

    return _fleet_deployment("cpu")


def _fixture_ok(phi, fx, rows):
    """Per-row ``max|phi - fixture phi|`` and whether each is within the
    fixture's bar (1e-4 + LOGIT_ULPS f32 ulps of p through the logit)."""

    ulp = 2.0 ** -24 * (2.0 + 2.0 * np.cosh(fx["raw_prediction"][rows, 1]))
    d = np.abs(np.asarray(phi) - fx["phi"][rows]).max((1, 2))
    return d, d <= 1e-4 + LOGIT_ULPS * ulp


def _pct(lat_s, q):
    return float(np.percentile(np.asarray(lat_s) * 1e3, q)) if len(lat_s) else float("nan")


def _ledger_bytes(model_id, version=None):
    """Live ledger bytes charged to ``model_id`` (one version, or all)."""

    from distributedkernelshap_tpu_torch.observability.memledger import memledger

    led = memledger()
    with led._lock:
        return sum(a._total for a in led._accounts.values()
                   if a.model == model_id and (version is None or a.version == version))


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class _InjectedCrash(RuntimeError):
    pass


class _ThreadScoped:
    """A fault injector whose crash kills the calling loop, not the process
    (``crash_scope="thread"``): an injected crash raises in the pipeline."""

    def __init__(self, spec):
        from distributedkernelshap_tpu_torch.resilience.faults import (
            FaultInjector,
            parse_faults,
        )

        self.inner = FaultInjector(parse_faults(spec))

    def fire(self, site, crash_scope="process"):
        kind = self.inner.fire(site, crash_scope="thread")
        if kind == "crash":
            raise _InjectedCrash(f"injected crash at {site}")
        return kind


def journal_phase(device, card):
    """Phase 40: the fixture LR's chunked explain through ``run_pipeline``
    with a ``ShardJournal``: a rerun replays every chunk from disk with no
    launch, a torn last record recomputes that chunk only, another
    fingerprint restarts the journal, and a run killed at ``pool.shard``
    resumes from the chunk it lost."""

    import tempfile

    from distributedkernelshap_tpu_torch.parallel.pipeline import run_pipeline
    from distributedkernelshap_tpu_torch.resilience import faults
    from distributedkernelshap_tpu_torch.resilience.journal import (
        ShardJournal,
        journal_fingerprint,
        run_journal_path,
    )
    from distributedkernelshap_tpu_torch.scheduling.result_cache import array_fingerprint

    fx = adult_fixture()
    n = JOURNAL_CHUNKS * JOURNAL_ROWS
    X = fx["X"][:n]
    ks = fixture_lr_explainer(fx, device)
    eng = ks._explainer
    fp = journal_fingerprint(eng)
    fp_cpu = journal_fingerprint(fixture_lr_explainer(fx, "cpu")._explainer)
    chunks = np.split(X, JOURNAL_CHUNKS)
    meta = {"fingerprint": fp, "input": array_fingerprint(X), "chunks": JOURNAL_CHUNKS}

    def fetch(fin):
        values, info = fin()
        return tuple(np.asarray(v) for v in values) + (np.asarray(info["raw_prediction"]),)

    def run(path, run_meta):
        reset_launches()
        t = time.perf_counter()
        with ShardJournal(path, run_meta) as j:
            out = run_pipeline(chunks, eng.get_explanation_async, fetch, window=2,
                               threaded=False, journal=j)
            stats = {k: v for k, v in j.stats().items() if k != "path"}
        _sync(device)
        return out, stats, kernel_launches()["fused_linear_ey"], time.perf_counter() - t

    def same(a, b):
        return all(len(x) == len(y) and all(np.array_equal(u, v) for u, v in zip(x, y))
                   for x, y in zip(a, b))

    with tempfile.TemporaryDirectory() as tmp:
        path = run_journal_path(tmp, fp, meta["input"])
        first, s1, l1, w1 = run(path, meta)
        again, s2, l2, w2 = run(path, meta)
        with open(path, "r", encoding="ascii") as f:
            lines = f.read().splitlines()
        with open(path, "w", encoding="ascii") as f:
            f.write("\n".join(lines[:-1] + [lines[-1][:len(lines[-1]) // 2]]))
        torn, s3, l3, _ = run(path, meta)
        other = dict(meta, fingerprint=journal_fingerprint(eng, extra={"nsamples": 1024}))
        restarted, s4, l4, _ = run(path, other)
        with open(path, "r", encoding="ascii") as f:
            header = json.loads(f.readline())
        crash_path = os.path.join(tmp, "crash.journal")
        real = faults.env_injector
        faults.env_injector = lambda: _ThreadScoped(
            f"crash:site=pool.shard,after={JOURNAL_CRASH_AFTER}")
        try:
            try:
                run(crash_path, meta)
                crashed = False
            except _InjectedCrash:
                crashed = True
        finally:
            faults.env_injector = real
        resumed, s5, l5, _ = run(crash_path, meta)
    phi = np.concatenate([np.stack(r[:-1], 1) for r in first])
    d_fix, ok = _fixture_ok(phi, fx, slice(0, n))
    print(f"journal: {JOURNAL_CHUNKS} chunks of {JOURNAL_ROWS} rows; fingerprint on {device} "
          f"== CPU {fp == fp_cpu}; run 1 {s1} launches {l1} ({1e3 * w1:.3f} ms); rerun {s2} launches "
          f"{l2} ({1e3 * w2:.3f} ms) bit-identical {same(first, again)}; torn last record "
          f"{s3} launches {l3} bit-identical {same(first, torn)}; another fingerprint {s4} "
          f"launches {l4}, header restarted {header.get('fingerprint') == other['fingerprint']}; "
          f"crash at pool.shard after {JOURNAL_CRASH_AFTER}: raised {crashed}, resume {s5} "
          f"launches {l5} bit-identical {same(first, resumed)}; |phi - fixture| max "
          f"{d_fix.max():.3e} (1e-4 + {LOGIT_ULPS} p-ulps) on {card}", flush=True)
    want_crash = JOURNAL_CHUNKS - JOURNAL_CRASH_AFTER
    if fp != fp_cpu or l1 != JOURNAL_CHUNKS or s1["computed"] != JOURNAL_CHUNKS \
            or l2 != 0 or s2["restored"] != JOURNAL_CHUNKS or not same(first, again) \
            or l3 != 1 or s3["restored"] != JOURNAL_CHUNKS - 1 or not same(first, torn) \
            or l4 != JOURNAL_CHUNKS or s4["restored"] != 0 or not same(first, restarted) \
            or header.get("fingerprint") != other["fingerprint"] or not crashed \
            or l5 != want_crash or s5["restored"] != JOURNAL_CRASH_AFTER \
            or s5["computed"] != want_crash or not same(first, resumed) or not ok.all():
        raise AssertionError("the shard journal is off")
    return {"launches": l1 + l3 + l4 + l5}


def _post_raw(port, body, headers, timeout=120.0):
    """One POST /explain without client retries: ``(status, body bytes)``."""

    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/explain", body=body, headers=headers)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _json_req(rows, model=None):
    doc = {"array": np.asarray(rows).tolist()}
    if model is not None:
        doc["model"] = model
    return json.dumps(doc).encode()


def gateway_phase(device, card, seed):
    """Phase 41: one ``ExplainerServer(registry=ModelRegistry())`` on the
    card serving four tenants — the fixture LR, its twin under a second id,
    the fixture GBT auto-exact and pinned to interactions — from 16 client
    threads: routing, shared batches of the two LR tenants, the exact
    kernels' launches, a hot swap under load, the freed device memory and
    a tenant quota.  Returns ``{kernel: launches}`` of the mixed load."""

    import gc
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import torch
    from distributedkernelshap_tpu_torch import KernelShap, TreeEnsemblePredictor
    from distributedkernelshap_tpu_torch.registry import ModelRegistry, TenantQuota
    from distributedkernelshap_tpu_torch.serving import client as cl
    from distributedkernelshap_tpu_torch.serving import wire
    from distributedkernelshap_tpu_torch.serving.server import ExplainerServer
    from distributedkernelshap_tpu_torch.serving.wrappers import BatchKernelShapModel

    fx = adult_fixture()
    X = fx["X"][:GATEWAY_LR_ROWS]
    on_card = _on_card(device)

    def lr_model():
        return BatchKernelShapModel.from_explainer(fixture_lr_explainer(fx, device))

    def gbt_model(kw):
        tree = TreeEnsemblePredictor(
            fx["tree_feature"], fx["tree_threshold"], fx["tree_left"], fx["tree_right"],
            fx["tree_value"], depth=int(fx["tree_depth"]), aggregation="sum",
            base=fx["tree_base"], scale=float(fx["tree_scale"]),
            missing_left=fx["tree_missing_left"], vector_out=False, device=device)
        tks = KernelShap(tree, task="regression", seed=0, device=device)
        tks.fit(fx["background"], group_names=fx["names"], groups=fx["groups"])
        return tks, BatchKernelShapModel.from_explainer(tks, explain_kwargs=kw)

    tks, gbt = gbt_model(None)
    _, gbt_inter = gbt_model({"nsamples": "exact", "interactions": True})
    reset_launches()
    tks.explain(X[:SERVE_TREE_REQUEST], nsamples="exact", silent=True)
    _sync(device)
    per_explain = kernel_launches()["exact_tree_phi"]
    n_inter_requests = GATEWAY_INTER_ROWS // SERVE_TREE_REQUEST
    reg = ModelRegistry()
    lr_v1 = reg.register("lr", lr_model())
    twin = reg.register("lr_twin", lr_model())
    reg.register("gbt", gbt)
    # the load's interaction requests, then one more, fit the bucket
    inter_rm = reg.register("gbt_inter", gbt_inter, quota=TenantQuota(
        rate_per_s=1e-3, burst=n_inter_requests + 1))
    dedicated = lr_model()
    keys = {rm.model_id: rm.share_key for rm in reg.active_models()}
    srv = ExplainerServer(registry=reg, host="127.0.0.1", port=0,
                          max_batch_size=SERVE_MAX_BATCH, pipeline_depth=4,
                          warmup=False).start()
    dispatches = []
    inner_dispatch = srv._dispatch_batch

    def logged_dispatch(live, leaders, index_map, t_claim, *a, **kw):
        rm = kw.get("rm")
        dispatches.append((rm.model_id if rm is not None else None, bool(kw.get("shared")),
                           len(leaders)))
        return inner_dispatch(live, leaders, index_map, t_claim, *a, **kw)

    srv._dispatch_batch = logged_dispatch
    url = f"http://127.0.0.1:{srv.port}/explain"
    out = {}
    try:
        # -- routing ------------------------------------------------------ #
        row = X[:1]
        st_h, p_h = _post_raw(srv.port, _json_req(row), {"Content-Type": "application/json",
                                                         "X-DKS-Model": "gbt"})
        st_j, p_j = _post_raw(srv.port, _json_req(row, "lr"),
                              {"Content-Type": "application/json"})
        st_w, p_w = _post_raw(srv.port, wire.encode_request(row, model_id="lr_twin"),
                              {"Content-Type": wire.CONTENT_TYPE})
        st_u, p_u = _post_raw(srv.port, _json_req(row, "nope"),
                              {"Content-Type": "application/json"})
        roster = json.loads(p_u).get("models") if st_u == 404 else None
        phi_h = np.asarray(json.loads(p_h)["data"]["shap_values"])
        phi_j = np.asarray(json.loads(p_j)["data"]["shap_values"])
        phi_w = np.asarray(json.loads(p_w)["data"]["shap_values"])
        route_ok = (st_h, st_j, st_w, st_u) == (200, 200, 200, 404) \
            and roster == ["lr", "lr_twin", "gbt", "gbt_inter"] \
            and phi_h.shape[0] == 1 and phi_j.shape[0] == 2 and phi_w.shape[0] == 2 \
            and rel_close(phi_h[0], fx["tree_phi"][:1]) >= 0 \
            and _fixture_ok(np.stack(list(phi_j), 1), fx, slice(0, 1))[1].all() \
            and _fixture_ok(np.stack(list(phi_w), 1), fx, slice(0, 1))[1].all()
        print(f"gateway routing: header -> gbt {st_h}, JSON field -> lr {st_j}, binary wire "
              f"field -> lr_twin {st_w}, unknown id {st_u} roster {roster}; share keys equal "
              f"lr/lr_twin {keys['lr'] == keys['lr_twin'] and keys['lr'] is not None}, gbt "
              f"distinct {keys['gbt'] not in (None, keys['lr'])}, gbt_inter "
              f"{keys['gbt_inter']}", flush=True)
        if not route_ok or keys["lr"] != keys["lr_twin"] or keys["lr"] is None \
                or keys["gbt_inter"] is not None:
            raise AssertionError("the gateway's routing is off")

        # -- one shared batch of lr and lr_twin, bit for bit -------------- #
        shared_ok = False
        for attempt in range(5):
            rows = X[2 + 2 * attempt:4 + 2 * attempt]
            dispatches.clear()
            reset_launches()
            with ThreadPoolExecutor(2) as pool:
                futs = [pool.submit(_post_raw, srv.port, _json_req(rows[i:i + 1]),
                                    {"Content-Type": "application/json",
                                     "X-DKS-Model": t})
                        for i, t in enumerate(("lr", "lr_twin"))]
                res = [f.result() for f in futs]
            _sync(device)
            launches = kernel_launches()["fused_linear_ey"]
            if len(dispatches) != 1 or not dispatches[0][1]:
                continue
            ded = dedicated.explain_batch(rows, split_sizes=[1, 1])
            bit = all(s == 200 and json.loads(p)["data"]["shap_values"]
                      == json.loads(d)["data"]["shap_values"] for (s, p), d in zip(res, ded))
            print(f"gateway shared batch (attempt {attempt + 1}): 1 dispatch of "
                  f"{dispatches[0][2]} requests from lr and lr_twin, fused_linear_ey launches "
                  f"{launches}; each slot's phi bit-identical to a dedicated dispatch at the "
                  f"same padded bucket: {bit}", flush=True)
            if (on_card and launches != 1) or not bit:
                raise AssertionError("the shared batch is off")
            shared_ok = True
            break
        if not shared_ok:
            raise AssertionError("no attempt coalesced lr and lr_twin into one dispatch")

        # -- the mixed load from 16 client threads ------------------------ #
        jobs = []
        for i, rows in enumerate(np.split(X, GATEWAY_LR_ROWS // SERVE_ROWS_PER_REQUEST)):
            jobs.append(("lr" if i % 2 == 0 else "lr_twin", i * SERVE_ROWS_PER_REQUEST, rows))
        for tenant, n_rows in (("gbt", GATEWAY_TREE_ROWS), ("gbt_inter", GATEWAY_INTER_ROWS)):
            for j in range(0, n_rows, SERVE_TREE_REQUEST):
                jobs.append((tenant, j, X[j:j + SERVE_TREE_REQUEST]))
        order = np.random.default_rng(0).permutation(len(jobs))
        jobs = [jobs[i] for i in order]
        lat = {t: [] for t in ("lr", "lr_twin", "gbt", "gbt_inter")}

        def one(job):
            tenant, start, rows = job
            t = time.perf_counter()
            body = cl.explain_request(url, rows, wire_format="binary",
                                      extra_headers={"X-DKS-Model": tenant})
            lat[tenant].append(time.perf_counter() - t)
            return body

        dispatches.clear()
        reset_launches()
        t = time.perf_counter()
        with ThreadPoolExecutor(SERVE_WORKERS) as pool:
            answers = list(pool.map(one, jobs))
        wall = time.perf_counter() - t
        _sync(device)
        launches = kernel_launches()
        by = {}
        for model_id, shared, _ in dispatches:
            group = "lr" if model_id in ("lr", "lr_twin") else model_id
            by[group] = by.get(group, 0) + 1
        n_shared = sum(1 for _, s, _ in dispatches if s)
        lr_phi = np.zeros((GATEWAY_LR_ROWS, 2, len(fx["names"])))
        tree_err = inter_err = 0.0
        for (tenant, start, rows), ans in zip(jobs, answers):
            if tenant in ("lr", "lr_twin"):
                lr_phi[start:start + rows.shape[0]] = np.stack(ans["shap_values"], 1)
            elif tenant == "gbt":
                tree_err = max(tree_err, rel_close(ans["shap_values"][0],
                                                   fx["tree_phi"][start:start + rows.shape[0]]))
            else:
                inter_err = max(inter_err, rel_close(ans["shap_values"][0],
                                                     fx["tree_phi"][start:start + rows.shape[0]]),
                                rel_close(ans["interaction_values"][0],
                                          fx["tree_interactions"][start:start + rows.shape[0]]))
        d_fix, ok = _fixture_ok(lr_phi, fx, slice(0, GATEWAY_LR_ROWS))
        want = {"fused_linear_ey": by.get("lr", 0),
                "exact_tree_phi": per_explain * by.get("gbt", 0) + by.get("gbt_inter", 0),
                "exact_tree_inter": by.get("gbt_inter", 0)}
        rows_of = {"lr": GATEWAY_LR_ROWS // 2, "lr_twin": GATEWAY_LR_ROWS // 2,
                   "gbt": GATEWAY_TREE_ROWS, "gbt_inter": GATEWAY_INTER_ROWS}
        per_tenant = "; ".join(
            f"{t} {len(v)} requests p50 {_pct(v, 50):.3f} ms p99 {_pct(v, 99):.3f} ms "
            f"{rows_of[t] / wall:.1f} rows/s" for t, v in lat.items())
        print(f"gateway load: {len(jobs)} requests ({sum(rows_of.values())} rows) from "
              f"{SERVE_WORKERS} threads in {1e3 * wall:.3f} ms "
              f"({sum(rows_of.values()) / wall:.1f} rows/s); {per_tenant}; dispatches by group "
              f"{by}, shared (lr + lr_twin in one call) {n_shared}; launches {launches} (want "
              f"{want}, exact_tree_phi {per_explain} a gbt batch); |phi LR - fixture| max "
              f"{d_fix.max():.3e} (1e-4 + {LOGIT_ULPS} p-ulps), gbt {tree_err:.3e}, gbt_inter "
              f"{inter_err:.3e} (tol {PHI_REL:g} x max(1, max|.|)) on {card}", flush=True)
        if not ok.all() or (on_card and launches != want) or n_shared < 1:
            raise AssertionError("the gateway's mixed load is off")
        out.update(launches)

        # -- hot swap of lr under load ------------------------------------ #
        est_v2 = AdultShapedLogisticRegression(np.random.default_rng(seed))
        ks_v2 = KernelShap(est_v2.predict_proba, link="logit", seed=0, device=device)
        ks_v2.fit(fx["background"], group_names=fx["names"], groups=fx["groups"])
        ref_v2 = np.stack(ks_v2.explain(X, silent=True).shap_values, 1)
        v1_engine = lr_v1.model.explainer._explainer
        v1_bytes = _ledger_bytes("lr", 1)
        requests = np.split(X, GATEWAY_LR_ROWS // SERVE_ROWS_PER_REQUEST)
        swap_times, answers_seen, lost = {}, [], []
        stop = threading.Event()
        after_swap = []

        def client(k):
            # closed loop over the requests until the swap is done and
            # SWAP_AFTER more requests were sent after it
            i = k
            while not stop.is_set() and i < 8 * len(requests):
                j = i % len(requests)
                t0 = time.perf_counter()
                try:
                    ans = cl.explain_request(url, requests[j], wire_format="binary",
                                             extra_headers={"X-DKS-Model": "lr"})
                except Exception as e:  # a lost request fails the check below
                    lost.append(repr(e))
                    return
                answers_seen.append((j, t0, time.perf_counter(), ans))
                if "end" in swap_times and t0 > swap_times["end"]:
                    after_swap.append(j)
                    if len(after_swap) >= SWAP_AFTER:
                        stop.set()
                i += SERVE_WORKERS

        def swapper():
            while len(answers_seen) < SWAP_AFTER and not stop.is_set():
                time.sleep(0.001)
            swap_times["start"] = time.perf_counter()
            try:
                reg.register("lr", BatchKernelShapModel.from_explainer(ks_v2))
                swap_times["end"] = time.perf_counter()
            except Exception as e:  # fails the check below; the load stops
                lost.append(f"register: {e!r}")
                stop.set()

        th = threading.Thread(target=swapper, daemon=True)
        clients = [threading.Thread(target=client, args=(k,), daemon=True)
                   for k in range(SERVE_WORKERS)]
        th.start()
        for c in clients:
            c.start()
        th.join(300)
        for c in clients:
            c.join(300)
        stop.set()
        gc.collect()
        _sync(device)
        which, bad = [], 0
        for j, t0, t1, ans in answers_seen:
            rows = slice(j * SERVE_ROWS_PER_REQUEST, (j + 1) * SERVE_ROWS_PER_REQUEST)
            phi = np.stack(ans["shap_values"], 1)
            is_v1 = bool(_fixture_ok(phi, fx, rows)[1].all())
            is_v2 = float(np.abs(phi - ref_v2[rows]).max()) <= PHI_ATOL
            which.append(1 if is_v1 and not is_v2 else 2 if is_v2 and not is_v1 else 0)
            if which[-1] == 0 or (t1 < swap_times["start"] and which[-1] != 1) \
                    or (t0 > swap_times["end"] and which[-1] != 2):
                bad += 1
        v1_left = len(v1_engine._dev_cache) + len(v1_engine._plan_consts_cache)
        print(f"gateway hot swap of lr v1 -> v2 (an LR from seed {seed}) under "
              f"{SERVE_WORKERS}-thread load: {len(answers_seen)} answered, {len(lost)} lost, "
              f"{which.count(1)} by v1 and {which.count(2)} by v2, {bad} answers off their "
              f"admitting version; register (warm, flip, drain) "
              f"{swap_times['end'] - swap_times['start']:.3f} s; v1 state {lr_v1.state}, its "
              f"device caches {v1_left} entries, ledger v1 {v1_bytes} -> "
              f"{_ledger_bytes('lr', 1)} bytes", flush=True)
        if bad or lost or "end" not in swap_times or not which.count(1) or not which.count(2) \
                or lr_v1.state != "retired" or v1_left or _ledger_bytes("lr", 1) \
                or not v1_bytes or reg.resolve("lr").version != 2:
            raise AssertionError("the hot swap is off")

        # -- unregistering a tenant frees its device caches --------------- #
        gc.collect()
        _sync(device)
        alloc0 = torch.cuda.memory_allocated(device) if on_card else 0
        twin_bytes = _ledger_bytes("lr_twin")
        reg.unregister("lr_twin")
        gc.collect()
        _sync(device)
        alloc1 = torch.cuda.memory_allocated(device) if on_card else 0
        print(f"gateway unregister lr_twin: ledger {twin_bytes} -> {_ledger_bytes('lr_twin')} "
              f"bytes, torch.cuda.memory_allocated {alloc0} -> {alloc1} (fell "
              f"{alloc0 - alloc1} bytes); roster {reg.model_ids()}", flush=True)
        if not twin_bytes or _ledger_bytes("lr_twin") or twin.state != "retired" \
                or (on_card and alloc0 - alloc1 < twin_bytes):
            raise AssertionError("unregistering lr_twin did not free its device caches")

        # -- a tenant over its quota -------------------------------------- #
        row = X[:SERVE_TREE_REQUEST]
        st1, _ = _post_raw(srv.port, _json_req(row), {"Content-Type": "application/json",
                                                      "X-DKS-Model": "gbt_inter"})
        st2, p2 = _post_raw(srv.port, _json_req(row), {"Content-Type": "application/json",
                                                       "X-DKS-Model": "gbt_inter"})
        st3, _ = _post_raw(srv.port, _json_req(row), {"Content-Type": "application/json",
                                                      "X-DKS-Model": "gbt"})
        reason = json.loads(p2).get("reason") if st2 == 429 else None
        _, metrics = _http_get(f"http://127.0.0.1:{srv.port}/metrics")
        _, statusz = _http_get(f"http://127.0.0.1:{srv.port}/statusz?format=json")
        panel = json.loads(statusz)["detail"]["registry"]
        print(f"gateway quota on gbt_inter ({inter_rm.quota.describe()}): last admitted {st1}, "
              f"next {st2} {reason}, gbt meanwhile {st3}; /statusz registry panel "
              f"{[(m['model_id'], m['version'], m['path'], m['state']) for m in panel['models']]}",
              flush=True)
        if (st1, st2, st3) != (200, 429, 200) or reason != "tenant_rate_limited" \
                or 'dks_registry_sheds_total{model="gbt_inter",reason="tenant_rate_limited"} 1' \
                not in metrics:
            raise AssertionError("the tenant quota is off")
    finally:
        srv.stop()
    return out


def _card_pids():
    """PIDs of the processes holding the card, as ``nvidia-smi`` lists them."""

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return {int(x) for x in out.split() if x.strip().isdigit()}


def _pid_alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    # a reaped child is gone; an unreaped one is a zombie holding nothing
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split()[2] != "Z"
    except OSError:
        return False


def _check_released(pids, what):
    """Every pid in ``pids`` has exited and none holds the card."""

    alive = sorted(p for p in pids if _pid_alive(p))
    on_card = _card_pids()
    held = sorted(set(pids) & on_card) if on_card is not None else []
    print(f"{what}: worker pids {sorted(pids)} exited: {not alive}; nvidia-smi compute apps "
          f"{sorted(on_card) if on_card is not None else 'not readable'}, workers among them "
          f"{held}", flush=True)
    if alive or held:
        raise AssertionError(f"{what}: worker processes left on the card: {alive or held}")


def _fleet_factory_name(device):
    import torch

    return "chip_smoke:fleet_factory" if torch.device(device).type == "cuda" \
        else "chip_smoke:fleet_factory_cpu"


def _wait_until(pred, budget_s, what, step=0.05):
    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 > budget_s:
            raise AssertionError(f"timed out after {budget_s:.0f} s waiting for {what}")
        time.sleep(step)
    return time.perf_counter() - t0


def fleet_phase(device, card, single):
    """Phase 42: the replica fleet on one card — ``ReplicaManager(2)``
    behind its fan-in proxy (both workers on card 0), the fixture's 2560
    rows through the proxy beside phase 39's single process (``single``),
    the workers' compile accounting on the federated ``/metrics``, hedging
    around a slowed worker, a SIGKILLed worker restarted by the
    supervisor, one autoscaler cycle, and ``serving.main --replica_procs
    2``; no worker left on the card after each stop."""

    import signal
    import socket
    import tempfile
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from distributedkernelshap_tpu_torch.resilience import HedgePolicy, RestartPolicy
    from distributedkernelshap_tpu_torch.serving import client as cl
    from distributedkernelshap_tpu_torch.serving import wire
    from distributedkernelshap_tpu_torch.serving.autoscaler import AutoscalerConfig
    from distributedkernelshap_tpu_torch.serving.replicas import ReplicaManager, _pinned_card

    fx = adult_fixture()
    X = fx["X"][:SERVE_N_ROWS]
    requests = np.split(X, SERVE_N_ROWS // SERVE_ROWS_PER_REQUEST)
    factory = _fleet_factory_name(device)
    env = {"PYTHONPATH": REPO_ROOT,
           "DKS_FAULTS": f"slow:site=server.explain,replica=1,times={FLEET_SLOW_TIMES},"
                         f"delay={FLEET_SLOW_S}"}
    headers = {"Content-Type": wire.CONTENT_TYPE, "Accept": wire.CONTENT_TYPE}

    def post(port, i):
        i %= len(requests)
        t = time.perf_counter()
        status, body = _post_raw(port, wire.encode_request(requests[i]), headers)
        return i, status, body, time.perf_counter() - t

    def phi_of(body):
        return np.stack(wire.decode_explanation(body)["shap_values"], 1)

    pids = set()
    t0 = time.perf_counter()
    mgr = ReplicaManager(2, factory=factory, max_batch_size=SERVE_MAX_BATCH,
                         env_extra=env, startup_timeout_s=300.0,
                         restart_policy=RestartPolicy(base_backoff_s=0.2, seed=0),
                         hedge_policy=HedgePolicy(quantile=0.99, min_delay_s=FLEET_HEDGE_S,
                                                  max_delay_s=FLEET_HEDGE_S,
                                                  initial_delay_s=FLEET_HEDGE_S))
    try:
        mgr.start()
        pids.update(p.pid for p in mgr.procs)
        _wait_until(lambda: all(r.alive for r in mgr.proxy.replicas), 300, "both replicas")
        up_s = time.perf_counter() - t0
        port = mgr.proxy.port
        url = f"http://127.0.0.1:{port}/explain"

        # -- compile accounting on the federated /metrics ---------------- #
        _, fed = _http_get(f"http://127.0.0.1:{port}/metrics?federate=1")
        compile_lines = [ln for ln in fed.splitlines() if ln.startswith("dks_compile_total{")]
        fresh = [ln for ln in compile_lines if 'kind="fresh"' in ln
                 and float(ln.rsplit(" ", 1)[1]) > 0]
        hits = {r: any('kind="cache_hit"' in ln and f'replica="{r}"' in ln
                       for ln in compile_lines) for r in ("0", "1")}
        pinned = [_pinned_card(k, os.environ.get("CUDA_VISIBLE_DEVICES")) for k in (0, 1)]
        print(f"fleet: 2 workers ({factory}) healthy behind the proxy after {up_s:.3f} s, "
              f"CUDA_VISIBLE_DEVICES {pinned}; federated dks_compile_total {compile_lines}",
              flush=True)
        if fresh or (_on_card(device) and (not all(hits.values()) or pinned != ["0", "0"])):
            raise AssertionError("a worker built a kernel or loaded none from the cache")

        # -- hedging around the slowed replica 1 -------------------------- #
        h0, w0 = mgr.proxy._m_hedges.value(), mgr.proxy._m_hedge_wins.value()
        hedged = []
        while len(hedged) < 5 * FLEET_HEDGE_REQUESTS and (
                len(hedged) < FLEET_HEDGE_REQUESTS
                or _replica_requests(port).get("1", 0) < FLEET_SLOW_TIMES):
            hedged.append(post(port, len(hedged)))
        time.sleep(FLEET_SLOW_S + 0.1)  # the slowed losers finish answering
        hedges = mgr.proxy._m_hedges.value() - h0
        wins = mgr.proxy._m_hedge_wins.value() - w0
        worst = max(t for _, _, _, t in hedged)
        ok = all(s == 200 and _fixture_ok(phi_of(b), fx, _rows_of(i))[1].all()
                 for i, s, b, _ in hedged)
        print(f"fleet hedging (DKS_FAULTS slow:site=server.explain,replica=1, {FLEET_SLOW_S} s "
              f"x {FLEET_SLOW_TIMES}; hedge after {FLEET_HEDGE_S} s): {len(hedged)} sequential "
              f"requests, {hedges:.0f} hedged, {wins:.0f} hedge wins, slowest answer "
              f"{1e3 * worst:.3f} ms, answers right {ok}", flush=True)
        if not ok or hedges < 1 or wins < 1 or worst >= FLEET_SLOW_S:
            raise AssertionError("the proxy did not hedge around the slowed replica")

        # -- throughput through the proxy --------------------------------- #
        before = _replica_requests(port)
        lat = []
        inner = cl.explain_request

        def timed(*a, **kw):
            t = time.perf_counter()
            res = inner(*a, **kw)
            lat.append(time.perf_counter() - t)
            return res

        cl.explain_request = timed
        try:
            t = time.perf_counter()
            payloads = cl.distribute_requests(url, X, batch_mode="default", minibatches=requests,
                                              max_workers=SERVE_WORKERS, wire_format="binary")
            wall = time.perf_counter() - t
        finally:
            cl.explain_request = inner
        after = _replica_requests(port)
        served = {r: after.get(r, 0) - before.get(r, 0) for r in after}
        phi = np.concatenate([np.stack(p["shap_values"], 1) for p in payloads])
        d_fix, ok = _fixture_ok(phi, fx, slice(0, SERVE_N_ROWS))
        print(f"fleet load: {SERVE_N_ROWS} rows as {len(requests)} binary requests of "
              f"{SERVE_ROWS_PER_REQUEST} from {SERVE_WORKERS} threads through the proxy: wall "
              f"{1e3 * wall:.3f} ms, {SERVE_N_ROWS / wall:.1f} rows/s, {len(requests) / wall:.1f} "
              f"requests/s, p50 {_pct(lat, 50):.3f} ms, p99 {_pct(lat, 99):.3f} ms; requests "
              f"answered by replica {served}; phase 39 single process (staged): wall "
              f"{1e3 * single['wall']:.3f} ms, {SERVE_N_ROWS / single['wall']:.1f} rows/s, p50 "
              f"{single['p50']:.3f} ms, p99 {single['p99']:.3f} ms; |phi - fixture| max "
              f"{d_fix.max():.3e} (1e-4 + {LOGIT_ULPS} p-ulps) on {card}", flush=True)
        if not ok.all() or len(served) < 2 or min(served.values()) < 1:
            raise AssertionError("the fleet's load is off")

        # -- SIGKILL replica 0 mid-load ----------------------------------- #
        victim = mgr.procs[0]
        victim_addr = mgr.proxy.replicas[0].address
        progress = []

        def kill_when_busy():
            while len(progress) < len(requests) // 4:
                time.sleep(0.001)
            os.kill(victim.pid, signal.SIGKILL)
            killed_at.append(time.perf_counter())

        killed_at = []

        def tracked(i):
            res = post(port, i)
            progress.append(i)
            return res

        killer = threading.Thread(target=kill_when_busy, daemon=True)
        killer.start()
        with ThreadPoolExecutor(SERVE_WORKERS) as pool:
            results = list(pool.map(tracked, range(len(requests))))
        killer.join(60)
        failed = [(i, s, b) for i, s, b, _ in results if s != 200]
        named = all(s == 502 and victim_addr.encode() in b for _, s, b in failed)
        right = all(_fixture_ok(phi_of(b), fx, _rows_of(i))[1].all()
                    for i, s, b, _ in results if s == 200)
        _wait_until(lambda: mgr.procs[0] is not victim and mgr.proxy.replicas[0].alive,
                    300, "the killed replica to be routable again")
        back_s = time.perf_counter() - killed_at[0]
        pids.update(p.pid for p in mgr.procs)
        restarts = mgr.supervisor.stats()["restarts_total"]
        print(f"fleet SIGKILL of replica 0 ({victim_addr}, pid {victim.pid}) after "
              f"{len(requests) // 4} answers: {len(failed)} of {len(results)} requests failed, "
              f"all 502 naming it: {named}; the rest answered right: {right}; supervisor "
              f"restarts {restarts}; routable again {back_s:.3f} s after the kill (process and "
              f"CUDA start, warmup ladder)", flush=True)
        if not named or not right or len(failed) > SERVE_WORKERS or restarts < 1:
            raise AssertionError("the killed replica's failure is off")
    finally:
        mgr.stop()
    pids.update(p.pid for p in mgr.procs)
    _check_released(pids, "fleet stop")

    # -- serving.main --replica_procs 2, started now: its start overlaps the
    # autoscaler cycle's ---------------------------------------------------- #
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        cli_port = s.getsockname()[1]
    t_cli = time.perf_counter()
    # the CLI's and its workers' logs go to a file: an undrained pipe could
    # fill and stall them
    log = tempfile.TemporaryFile()
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributedkernelshap_tpu_torch.serving.main",
         "--replica_procs", "2", "--factory", factory, "--host", "127.0.0.1",
         "--port", str(cli_port), "--max_batch_size", "8"],
        cwd=REPO_ROOT, stdout=log, stderr=subprocess.STDOUT)
    workers = set()
    try:
        # -- one autoscaler cycle: 1 -> 2 on queue pressure -> 1 -------------- #
        pids = set()
        cfg = AutoscalerConfig(min_replicas=1, max_replicas=2, interval_s=0.2, up_ticks=1,
                               down_ticks=3, up_cooldown_s=0.5, down_cooldown_s=0.5,
                               queue_wait_up_s=0.005, replica_wait_up_s=0.005,
                               trend_factor=1e9, down_utilization=0.9, drain_timeout_s=30.0)
        mgr = ReplicaManager(1, factory=factory, max_batch_size=SCALE_MAX_BATCH,
                             env_extra={"PYTHONPATH": REPO_ROOT}, startup_timeout_s=300.0,
                             restart_policy=RestartPolicy(base_backoff_s=0.2, seed=0),
                             autoscale=cfg)
        try:
            mgr.start()
            pids.update(p.pid for p in mgr.procs)
            port = mgr.proxy.port
            stop = threading.Event()
            answers, lost = [], []
            url = f"http://127.0.0.1:{port}/explain"

            def flood(k):
                i = k
                while not stop.is_set():
                    j = i % len(requests)
                    try:
                        answers.append((j, cl.explain_request(url, requests[j],
                                                              wire_format="binary")))
                    except Exception as e:  # a lost request: the check below fails
                        lost.append((j, repr(e)))
                    i += SCALE_CLIENTS

            threads = [threading.Thread(target=flood, args=(k,), daemon=True)
                       for k in range(SCALE_CLIENTS)]
            for th in threads:
                th.start()
            try:
                up_s = _wait_until(lambda: mgr.proxy.replica_state_counts()["ready"] >= 2, 300,
                                   "the scale-up to 2 ready replicas")
                time.sleep(1.0)  # both serve under the flood
            finally:
                stop.set()
                for th in threads:
                    th.join(120)
            pids.update(p.pid for p in mgr.procs if p is not None)
            down_s = _wait_until(lambda: mgr.proxy.replica_state_counts()["ready"] == 1
                                 and mgr.proxy.replica_state_counts()["retired"] >= 1, 300,
                                 "the drain back to 1 replica")
            _, page = _http_get(f"http://127.0.0.1:{port}/metrics")
            decisions = [ln for ln in page.splitlines()
                         if ln.startswith("dks_autoscale_decisions_total{")
                         and not ln.endswith(" 0")]
            right = all(_fixture_ok(np.stack(a["shap_values"], 1), fx, _rows_of(j))[1].all()
                        for j, a in answers)
            print(f"fleet autoscaler (max_batch_size {SCALE_MAX_BATCH}, {SCALE_CLIENTS} flooding "
                  f"clients): 2 ready {up_s:.3f} s after the flood began, back to 1 ready and 1 "
                  f"retired {down_s:.3f} s after it stopped; {len(answers)} requests answered, "
                  f"{len(lost)} lost, every answer its own rows' phi: {right}; decisions "
                  f"{decisions}", flush=True)
            if lost or not answers or not right \
                    or not any("scale_up" in ln for ln in decisions) \
                    or not any("scale_down" in ln for ln in decisions):
                raise AssertionError("the autoscaler cycle is off")
        finally:
            mgr.stop()
        pids.update(p.pid for p in mgr.procs if p is not None)
        _check_released(pids, "autoscaled fleet stop")


        def healthy():
            workers.update(_children(proc.pid))
            if proc.poll() is not None:
                log.seek(0)
                raise AssertionError("serving.main --replica_procs exited: "
                                     + log.read().decode()[-2000:])
            try:
                code, _ = _http_get(f"http://127.0.0.1:{cli_port}/healthz", timeout=5)
            except OSError:
                return False
            return code == 200

        _wait_until(healthy, 300, "serving.main --replica_procs 2", step=0.1)
        cli_s = time.perf_counter() - t_cli
        workers.update(_children(proc.pid))
        body = cl.explain_request(f"http://127.0.0.1:{cli_port}/explain", X[:2],
                                  wire_format="binary")
        _, cli_ok = _fixture_ok(np.stack(body["shap_values"], 1), fx, slice(0, 2))
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    print(f"fleet CLI (serving.main --replica_procs 2 --factory {factory}): healthy "
          f"{cli_s:.3f} s after its start (beside the autoscaler cycle), {len(workers)} "
          f"worker processes, answer right {bool(cli_ok.all())}, "
          f"exit {rc} on SIGTERM", flush=True)
    if rc != 0 or not cli_ok.all() or len(workers) != 2:
        raise AssertionError("serving.main --replica_procs is off")
    _check_released(workers, "CLI fleet stop")


def _on_card(device):
    import torch

    return torch.device(device).type == "cuda"


def _children(pid):
    """The replica worker processes among ``pid``'s children, by process
    id (some kernels list a child's threads in ``children`` too: each
    entry maps to its thread group's id)."""

    try:
        with open(f"/proc/{pid}/task/{pid}/children") as f:
            kids = [int(x) for x in f.read().split()]
    except OSError:
        return set()
    out = set()
    for kid in kids:
        try:
            with open(f"/proc/{kid}/cmdline", "rb") as f:
                worker = b"replica_worker" in f.read()
            with open(f"/proc/{kid}/status") as f:
                tgid = next(int(ln.split()[1]) for ln in f if ln.startswith("Tgid:"))
        except (OSError, StopIteration, ValueError):
            continue
        if worker:
            out.add(tgid)
    return out


def _replica_requests(port):
    """``{replica: requests answered}`` from the proxy's federated page."""

    _, fed = _http_get(f"http://127.0.0.1:{port}/metrics?federate=1")
    out = {}
    for ln in fed.splitlines():
        if ln.startswith("dks_serve_requests_total{"):
            rep = ln.split('replica="', 1)[1].split('"', 1)[0]
            out[rep] = out.get(rep, 0) + float(ln.rsplit(" ", 1)[1])
    return out


def _rows_of(i):
    """The fixture rows of phase 42's ``i``-th request."""

    return slice(i * SERVE_ROWS_PER_REQUEST, (i + 1) * SERVE_ROWS_PER_REQUEST)


def cuda_time_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ey_bound_ms(B, S, N, M, K, activation, sm_count, sm_clock_hz, design="paired"):
    """The least time the card could take for one ``fused_linear_ey`` call:
    the larger of its bytes (each input read once, the output written once)
    over HBM bandwidth and its operations over the peak rate of their unit,
    the special-function units (SFUs) and the FP32 lanes working at once.

    A sigmoid-form call (binary softmax carries one class, sigmoid K) has
    B·S·N·KE activations ``w / (1 + u·v)`` and (B·S + S·N)·KE exponentials
    ``u``, ``v``, each exponential with the M FMAs of its group contraction.
    ``design`` says how an activation's reciprocal is counted:

    - ``"paired"``, the function's floor, the bound: two activations share
      one reciprocal (``1/(a·b)``, then ``1/a = b/(a·b)``), so an activation
      costs half an SFU reciprocal and 3.5 FP32 instructions (of the seven
      a pair takes: two FFMAs forming a and b, their product, the two
      products back and two FFMAs into the sums).  At the headline (B =
      2560, S = 2072, N = 100, K = 2) 270.7 M SFU operations: 0.0647 ms at
      1980 MHz on 132 SMs, over the 0.0575 ms of the FP32 lanes;
    - ``"factored"``, the floor of the kernel's own design: one reciprocal
      per activation on the SFUs and 2 FP32 instructions (the FFMA forming
      1 + u·v, the FFMA into the sum).  535.9 M SFU operations at the
      headline, 0.1282 ms;
    - ``"unfactored"``, the yardstick of the unfactored form (PRs 1–5): an
      exp and a reciprocal per activation on the SFUs (530.4 M activations:
      0.2537 ms at the headline), 2·M FLOP per (b, s, class) and per
      (s, n, class) product, plus ~3 FLOP per activation.

    A general softmax (K != 2) takes, in the paired and factored designs,
    the floor of ``softmax_factored_kernel``'s factored form: B·S·N
    reciprocals and K·(B·S + S·N) exponentials on the SFUs, 2·K·B·S·N
    FFMAs (D = Σ_k u·v, then Σ_n r·v) and M·K·(B·S + S·N) on the FP32
    lanes: 3.3688 ms at K = 100 and the headline shape, 6.0241 ms at a
    Covertype chunk (B = 65536, K = 7), both FP32-bound.  ``"unfactored"``
    keeps its earlier count: K exps and one reciprocal per activation on
    the SFUs (12.8113 and 25.9777 ms there)."""

    binary = activation == "softmax" and K == 2
    KE = 1 if binary else K
    acts = B * S * N
    per_s = sm_count * sm_clock_hz
    fp32_lanes = per_s * FP32_LANES_PER_SM
    per_act = {"paired": (0.5, 3.5), "factored": (1, 2)}
    if design not in ("paired", "factored", "unfactored"):
        raise ValueError(f"design must be 'paired', 'factored' or 'unfactored', "
                         f"got {design!r}")
    if design in per_act and (binary or activation == "sigmoid"):
        sfu_act, fp32_act = per_act[design]
        sfu = KE * (sfu_act * acts + B * S + S * N)
        fp32_s = KE * (fp32_act * acts + M * (B * S + S * N)) / fp32_lanes
    elif design in per_act:
        sfu = acts + K * (B * S + S * N)
        fp32_s = K * (2 * acts + M * (B * S + S * N)) / fp32_lanes
    else:
        sfu = acts * (2 * KE if activation == "sigmoid" or binary else KE + 1)
        fp32_s = (2 * M * KE * (B * S + S * N) + 3 * acts * KE) / FP32_FLOPS_PER_S
    nbytes = 4 * (B * M * K + N * M * K + N * K + N + S * M + B * S * K)
    times = {
        "bytes": nbytes / HBM_BYTES_PER_S,
        "operations": max(sfu / (per_s * SFU_OPS_PER_SM_PER_CLOCK), fp32_s),
    }
    bound_by = max(times, key=times.get)
    return 1e3 * times[bound_by], bound_by


def compare_kernel(seed, device):
    """Phase 3: the wrapper (kernel) against the plain version on the card,
    at the main path's shapes, the edge shapes and the adversarial
    sigmoid-form inputs (:func:`adversarial_ey_inputs`: large logits, a
    t' range past the guard, cancelling logits, and N above one staged
    chunk), with the guard's split of each sigmoid-form case; the general
    softmax's factored kernel on every adversarial kind (top classes apart
    too) at ``EY_SOFTMAX_ADVERSARIAL_KS`` classes, with the (b, s, n)
    triples its guard sent to the in-kernel exact route; the library's
    route for each K (the small-K route up to ``ey_regs_max_k``, the
    factored kernel past it, the sigmoid form at K = 2), the small-K
    route's shapes (one class, one and two float4s of v, classes past K
    zero, several background chunks, XWg staged in slices at 48 groups),
    two launches of it bit-identical, and what it launches."""

    import torch

    from distributedkernelshap_tpu_torch.ops import cuda_kernels
    from distributedkernelshap_tpu_torch.ops.cuda_kernels import (
        ey_launch_info,
        fused_linear_ey,
        fused_linear_ey_plain,
    )

    rng = np.random.default_rng(seed)
    headline_mask = coalition_plan_mask()
    small = cuda_kernels.ey_regs_max_k()
    for K in (1, 3, 7, 8, small):
        info = ey_launch_info(COVERTYPE_CHUNK, len(headline_mask), N_BACKGROUND,
                              len(COVERTYPE_WIDTHS), K)
        print(f"small-K route launch at B={COVERTYPE_CHUNK} S={len(headline_mask)} "
              f"N={N_BACKGROUND} M={len(COVERTYPE_WIDTHS)} K={K}: {info}", flush=True)
        if info["route"] != "regs" or info["local_bytes"]:
            raise AssertionError(f"the small-K route at K={K}: {info}")
    routes = {K: cuda_kernels.ey_route(K) for K in (*range(1, small + 2), 32, 100)}
    want = {K: "sigmoid" if K == 2 else "regs" if K <= small else "factored" for K in routes}
    print(f"fused_linear_ey routes (softmax): {routes}; sigmoid K=1, 7: "
          f"{cuda_kernels.ey_route(1, 'sigmoid')}, {cuda_kernels.ey_route(7, 'sigmoid')}",
          flush=True)
    if routes != want or {cuda_kernels.ey_route(K, "sigmoid") for K in (1, 7)} != {"sigmoid"}:
        raise AssertionError(f"fused_linear_ey's routes {routes}, want {want}")
    cases = [
        ("headline binary softmax", 2560, 2072, 100, 12, 2, "softmax", headline_mask),
        ("general softmax K=7", 512, 1024, 100, 12, 7, "softmax", None),
        ("sigmoid K=1", 512, 1024, 100, 12, 1, "sigmoid", None),
        ("sigmoid K=2", 512, 1024, 100, 12, 2, "sigmoid", None),
        ("ragged edges binary", 33, 700, 9, 7, 2, "softmax", None),
        ("ragged edges K=7", 33, 700, 9, 7, 7, "softmax", None),
        ("wide K=32 softmax", 40, 300, 20, 12, 32, "softmax", None),
        # the small-K route: one class, one and two float4s of v, classes
        # past K zero, background rows past a chunk, XWg in slices
        ("small-K route K=1", 512, 1024, 100, 12, 1, "softmax", None),
        ("small-K route K=8", 512, 1024, 100, 12, 8, "softmax", None),
        ("small-K route K=11", 300, 700, 100, 12, 11, "softmax", None),
        (f"small-K route K={small}, ragged edges", 33, 700, 9, 7, small, "softmax", None),
        ("small-K route K=3, N above one chunk", 100, 200, 300, 12, 3, "softmax", None),
        ("small-K route K=7, N above one chunk", 100, 200, 300, 12, 7, "softmax", None),
        ("small-K route K=7 M=48", 256, 600, 100, 48, 7, "softmax", None),
        (f"small-K route K={small} M=48", 128, 600, 100, 48, small, "softmax", None),
        ("N above one chunk, binary", 256, 1024, 300, 12, 2, "softmax", None),
        ("N above one chunk, sigmoid K=1", 256, 1024, 300, 12, 1, "sigmoid", None),
        # groups in several staged slices of 16 (ungrouped Adult: M = 48)
        ("binary M=48", 256, 1024, 100, 48, 2, "softmax", None),
        ("binary M=17", 256, 1024, 100, 17, 2, "softmax", None),
        ("sigmoid K=2 M=48", 256, 1024, 100, 48, 2, "sigmoid", None),
        ("sigmoid K=1 M=17", 256, 1024, 100, 17, 1, "sigmoid", None),
        # the l1 phase's device pass: ungrouped Adult, its default plan's mask
        ("l1 pass, ungrouped binary M=48", B_L1, len(l1_plan_mask()), N_BACKGROUND,
         sum(ADULT_WIDTHS), 2, "softmax", l1_plan_mask()),
        # sigmoid classes on the grid's z axis
        ("sigmoid K=7", 512, 1024, 100, 12, 7, "sigmoid", None),
        ("sigmoid K=32", 128, 512, 100, 12, 32, "sigmoid", None),
        ("ragged edges sigmoid K=3", 33, 700, 9, 7, 3, "sigmoid", None),
        ("N above one chunk, sigmoid K=3 M=20", 100, 300, 250, 20, 3, "sigmoid", None),
    ]
    for kind in EY_ADVERSARIAL:
        cases += [(f"{kind}, binary", 256, 1024, 100, 12, 2, "softmax", kind),
                  (f"{kind}, sigmoid K=2", 256, 1024, 100, 12, 2, "sigmoid", kind),
                  (f"{kind}, sigmoid K=7 M=48", 64, 300, 100, 48, 7, "sigmoid", kind),
                  (f"{kind}, binary, N above one chunk", 128, 512, 300, 12, 2, "softmax",
                   kind)]
    for kind in EY_SOFTMAX_ADVERSARIAL:
        cases += [(f"{kind}, softmax K={K}", 128, 512, 100, 12, K, "softmax", kind)
                  for K in EY_SOFTMAX_ADVERSARIAL_KS]
    # past the classes whose u a block keeps for every class: u formed per
    # class tile
    cases += [("u per class tile, softmax K=1000", 64, 256, 100, 12, 1000, "softmax", None),
              ("u per class tile, ragged edges, softmax K=1000", 33, 70, 9, 7, 1000, "softmax",
               None),
              ("u per class tile, top classes apart, softmax K=1000", 32, 64, 300, 12, 1000,
               "softmax", "top classes apart")]
    worst = 0.0
    for name, B, S, N, M, K, act, mask in cases:
        if isinstance(mask, str):
            args = adversarial_ey_inputs(rng, mask, B, S, N, M, K, act, device)
        else:
            args = group_space_inputs(rng, B, S, N, M, K, device, mask)
        got = fused_linear_ey(*args, act)
        ref = fused_linear_ey_plain(*args, act)
        err = float((got - ref).abs().max())
        finite = bool(got.isfinite().all())
        if act == "softmax" and K != 2 and K <= small \
                and not bool(torch.equal(got, fused_linear_ey(*args, act))):
            raise AssertionError(f"two launches of the small-K route differ at {name}")
        guard = ""
        if act == "sigmoid" or K == 2:
            st = ey_guard_stats(args, act, ey_launch_info(B, S, N, M, K, act)["chunk_rows"])
            guard = (f"; guard: {st['exact_route']} of {st['columns']} (class, coalition, "
                     f"chunk) columns on the exact loop, {st['rows_clamped']} of "
                     f"{st['rows']} factored rows clamped")
        else:
            st = softmax_guard_stats(args)
            guard = (f"; guard: {st['exact_route']} of {st['triples']} (b, s, n) on the "
                     f"in-kernel exact route")
        print(f"kernel vs plain [{name}] B={B} S={S} N={N} M={M} K={K} "
              f"({cuda_kernels.ey_route(K, act)}): max_abs_diff={err:.3e} (tol {EY_ATOL:g})"
              f"{guard}", flush=True)
        if not finite or not err <= EY_ATOL:
            raise AssertionError(f"fused_linear_ey disagrees with its plain version "
                                 f"at {name}: {err} (finite={finite})")
        worst = max(worst, err)
    # past 32 classes: softmax through the factored kernel's class tiles,
    # sigmoid one class a block, at the headline-like shape, ragged edges
    # and N above one staged chunk
    for K in WIDE_EY_KS:
        for act in ("softmax", "sigmoid"):
            for label, B, S, N, M in WIDE_EY_SHAPES:
                args = group_space_inputs(rng, B, S, N, M, K, device)
                got = fused_linear_ey(*args, act)
                ref = fused_linear_ey_plain(*args, act)
                err = float((got - ref).abs().max())
                finite = bool(got.isfinite().all())
                info = ey_launch_info(B, S, N, M, K, act)
                guard = ""
                if act == "softmax":
                    st = softmax_guard_stats(args)
                    guard = f"; {st['exact_route']} of {st['triples']} (b, s, n) exact"
                print(f"kernel vs plain [{act} K={K}, {label}] B={B} S={S} N={N} M={M}: "
                      f"max_abs_diff={err:.3e} (tol {EY_ATOL:g}); {info['blocks']} blocks, "
                      f"{info['chunk_rows']} background rows a chunk{guard}", flush=True)
                if not finite or not err <= EY_ATOL:
                    raise AssertionError(f"fused_linear_ey disagrees with its plain "
                                         f"version at {act} K={K}, {label}: {err}")
                worst = max(worst, err)
    # above sigmoid's class limit (the grid's z axis) a card tensor raises,
    # never runs plain
    K = cuda_kernels.MAX_SIGMOID_K + 1
    try:
        cuda_kernels.fused_linear_ey(*group_space_inputs(rng, 1, 1, 1, 1, K, device),
                                     "sigmoid")
    except ValueError as e:
        print(f"kernel at sigmoid K={K} raises on the card: {e}", flush=True)
    else:
        raise AssertionError(f"fused_linear_ey took sigmoid K={K} > MAX_SIGMOID_K")
    # the factored kernel against the plain version's time at K = 32, same
    # inputs, timed plain, kernel, kernel, plain (for the record)
    B, S, N, M, K = 512, 1024, 100, 12, 32
    args = group_space_inputs(rng, B, S, N, M, K, device)
    err = float((fused_linear_ey(*args) - fused_linear_ey_plain(*args)).abs().max())
    if not err <= EY_ATOL:
        raise AssertionError(f"the factored kernel disagrees with the plain version "
                             f"at K={K}: {err}")
    worst = max(worst, err)
    ab = {"plain": [], "kernel": []}
    for arm in ("plain", "kernel", "kernel", "plain"):
        fn = (lambda: fused_linear_ey(*args)) if arm == "kernel" \
            else (lambda: fused_linear_ey_plain(*args))
        ab[arm].append(cuda_time_ms(fn, 10 if arm == "kernel" else 2))
    print(f"A/B at softmax K={K} B={B} S={S} N={N} M={M} on {card_line()}: "
          f"softmax_factored_kernel {ab['kernel']} ms, plain {ab['plain']} ms "
          f"(order plain, kernel, kernel, plain); kernel vs plain {err:.3e}", flush=True)
    return worst


def ey_kernel_report(lib_path, sm_count):
    """``fused_linear_ey``'s build report (registers and spills per kernel
    function, from the ``.log`` beside its library) and what the headline
    call launches (``ey_launch_info``): blocks, registers, local memory,
    shared memory, resident blocks per SM, blocks per SM over the grid and
    waves."""

    from distributedkernelshap_tpu_torch.ops import cuda_kernels

    log = lib_path.with_name(lib_path.name + ".log")
    rows = cuda_kernels.ptxas_report(log.read_text() if log.exists() else "")
    for r in rows:
        print(f"  ptxas fused_linear_ey: {tile_name(r['function'])}: {r.get('registers')} "
              f"registers, {r.get('stack_bytes')} B stack, spill stores "
              f"{r.get('spill_stores')} B, spill loads {r.get('spill_loads')} B", flush=True)
    if not any("sigmoid_kernel" in r["function"] for r in rows):
        raise AssertionError(f"no ptxas report for fused_linear_ey's kernels in {log}")
    S = len(coalition_plan_mask())
    info = cuda_kernels.ey_launch_info(B_HEADLINE, S, N_BACKGROUND, len(ADULT_WIDTHS), 2,
                                       "softmax")
    waves = info["blocks"] / (sm_count * info["blocks_per_sm"])
    print(f"  fused_linear_ey headline launch (B={B_HEADLINE} S={S} N={N_BACKGROUND} K=2, "
          f"sigmoid_kernel<true>): {info}; {info['blocks'] / sm_count:.2f} blocks per "
          f"SM over the grid, {waves:.2f} waves of {sm_count * info['blocks_per_sm']}",
          flush=True)
    return info


def coalition_plan_mask():
    from distributedkernelshap_tpu_torch.ops.coalitions import coalition_plan

    return coalition_plan(len(ADULT_WIDTHS), None, seed=0).mask


def l1_plan_mask():
    """The default coalition plan of the ungrouped Adult-shaped rows (M = 48),
    the one the l1 phase's explain samples."""

    from distributedkernelshap_tpu_torch.ops.coalitions import coalition_plan

    return coalition_plan(sum(ADULT_WIDTHS), None, seed=0).mask


def adult_task(seed):
    rng = np.random.default_rng(seed)
    X = adult_shaped_rows(rng, B_HEADLINE)
    bg = adult_shaped_rows(rng, N_BACKGROUND)
    return X, bg, AdultShapedLogisticRegression(rng)


def headline_explainer(bg, est, device, use_kernel=None, transfer_dtype=None,
                       plan_constant_cache=None, instance_chunk=None):
    from distributedkernelshap_tpu_torch import EngineConfig, KernelShap
    from distributedkernelshap_tpu_torch.ops.explain import ShapConfig

    explainer = KernelShap(est.predict_proba, link="logit",
                           feature_names=ADULT_GROUP_NAMES, seed=0, device=device,
                           engine_config=EngineConfig(
                               shap=ShapConfig(use_kernel=use_kernel,
                                               transfer_dtype=transfer_dtype),
                               plan_constant_cache=plan_constant_cache,
                               instance_chunk=instance_chunk))
    return explainer.fit(bg, group_names=ADULT_GROUP_NAMES, groups=adult_groups())


def explain_headline(X, bg, est, device, **kw):
    explainer = headline_explainer(bg, est, device, **kw)
    return explainer, explainer.explain(X, silent=True)


def additivity(expl) -> float:
    total = np.stack(expl.shap_values, 1).sum(-1) + np.asarray(expl.expected_value)[None]
    return float(np.abs(total - expl.data["raw"]["raw_prediction"]).max())


def check_explanation(expl, B, K=2, M=len(ADULT_WIDTHS)):
    """``(phi (B, K, M), additivity)`` of a sampled explanation, checked
    finite, of the expected shape and additive (< ``ADDITIVITY``)."""

    phi = np.stack(expl.shap_values, 1)
    if phi.shape != (B, K, M) or not np.isfinite(phi).all():
        raise AssertionError(f"bad shap values: shape {phi.shape}, "
                             f"finite={np.isfinite(phi).all()}")
    err = additivity(expl)
    if not err < ADDITIVITY:
        raise AssertionError(f"additivity violated: {err}")
    return phi, err


# ---------------------------------------------------------------------- #
# exact TreeSHAP (exact_tree_phi)


def adult_shaped_gbt(seed):
    """Node tables of an Adult-shaped boosted ensemble: ``N_TREES`` trees,
    each grown best-first (split the leaf holding the most sample rows) to
    at most ``MAX_LEAVES`` leaves by a random column and a threshold drawn
    from that column's values at the leaf; leaf values ~N(0, 0.1)."""

    rng = np.random.default_rng([seed, 7])
    return grow_gbt(rng, adult_shaped_rows(rng, 2000))


def grow_gbt(rng, sample, T=N_TREES):
    """Node tables of ``T`` trees over ``sample``'s columns, each grown
    best-first to at most ``MAX_LEAVES`` leaves by random splits (see
    :func:`adult_shaped_gbt`)."""

    n_nodes = 2 * MAX_LEAVES - 1
    feature = np.zeros((T, n_nodes), np.int64)
    threshold = np.full((T, n_nodes), np.inf, np.float32)
    left = np.tile(np.arange(n_nodes), (T, 1))
    right = left.copy()
    value = np.zeros((T, n_nodes, 1), np.float32)
    depth = 0
    for t in range(T):
        rows = {0: np.arange(sample.shape[0])}   # leaf -> sample rows
        node_depth = {0: 0}
        n_used = 1
        while len(rows) < MAX_LEAVES:
            j = max(rows, key=lambda leaf: rows[leaf].shape[0])
            sub = sample[rows[j]]
            cols = np.flatnonzero(np.ptp(sub, axis=0) > 0)
            if not cols.size:
                break
            c = int(rng.choice(cols))
            vals = np.unique(sub[:, c])
            thr = np.float32(rng.choice(vals[:-1]))
            go_left = sub[:, c] <= thr
            lc, rc = n_used, n_used + 1
            n_used += 2
            feature[t, j], threshold[t, j] = c, thr
            left[t, j], right[t, j] = lc, rc
            rows[lc], rows[rc] = rows[j][go_left], rows[j][~go_left]
            del rows[j]
            node_depth[lc] = node_depth[rc] = node_depth[j] + 1
        for leaf in rows:
            value[t, leaf, 0] = rng.normal(scale=0.1)
        depth = max(depth, max(node_depth.values()))
    return dict(feature=feature, threshold=threshold, left=left, right=right,
                value=value, depth=depth)


def tree_predictor(tables, device, head="identity", base=GBT_BASE):
    """The ensemble's raw margin (``head='identity'``, K = 1), or the
    probability pair ``HistGradientBoostingClassifier.predict_proba`` lifts
    to (``head='binary_sigmoid'``, K = 2)."""

    from distributedkernelshap_tpu_torch import TreeEnsemblePredictor

    return TreeEnsemblePredictor(
        tables["feature"], tables["threshold"], tables["left"], tables["right"],
        tables["value"], depth=tables["depth"], aggregation="sum", base=[base],
        out_transform=head, vector_out=head != "identity", device=device)


def explain_exact(tables, X, bg, device, pack_paths=None, use_kernel=None,
                  interactions=False, instance_chunk=None, grouped=True):
    """The ensemble's exact explain of ``X``: over the Adult groups, or
    (``grouped=False``) over every column."""

    from distributedkernelshap_tpu_torch import EngineConfig, KernelShap
    from distributedkernelshap_tpu_torch.ops.explain import ShapConfig

    explainer = KernelShap(tree_predictor(tables, device), task="regression", seed=0,
                           device=device, engine_config=EngineConfig(
                               shap=ShapConfig(pack_paths=pack_paths, use_kernel=use_kernel),
                               instance_chunk=instance_chunk))
    if grouped:
        explainer.fit(bg, group_names=ADULT_GROUP_NAMES, groups=adult_groups())
    else:
        explainer.fit(bg)
    return explainer, explainer.explain(X, nsamples="exact", silent=True,
                                        interactions=interactions)


def exact_phi(expl, B, M=len(ADULT_WIDTHS)):
    phi = np.asarray(expl.shap_values[0])
    if phi.shape != (B, M) or not np.isfinite(phi).all():
        raise AssertionError(f"bad exact shap values: shape {phi.shape}, "
                             f"finite={np.isfinite(phi).all()}")
    err = additivity(expl)
    if not err < EXACT_ADDITIVITY:
        raise AssertionError(f"exact additivity violated: {err}")
    return phi, err


def phi_tol(ref) -> float:
    return PHI_REL * max(1.0, float(np.abs(ref).max()))


def coalition_values(tables, x, bg, device):
    """The value of every one of the 2^12 group coalitions at ``x`` against
    ``bg`` (uniform weights): the ensemble's mean margin over the background
    rows with the coalition's columns taken from ``x``, the predictor
    evaluated on the card, the mean in float64.  Returns ``(masks (2^M, M)
    bool, values (2^M,))``; coalition ``i`` holds group ``m`` iff bit ``m``
    of ``i`` is set."""

    import torch

    M = len(ADULT_WIDTHS)
    masks = ((np.arange(2 ** M)[:, None] >> np.arange(M)[None]) & 1).astype(bool)
    G = np.zeros((M, sum(ADULT_WIDTHS)), bool)
    for m, cols in enumerate(adult_groups()):
        G[m, cols] = True
    colmask = (masks.astype(np.float32) @ G.astype(np.float32)) > 0.5   # (2^M, D)
    rows = np.where(colmask[:, None, :], x[None, None, :], bg[None])      # (2^M, N, D)
    pred = tree_predictor(tables, device)
    with torch.no_grad():
        f = pred(torch.as_tensor(rows.reshape(-1, rows.shape[-1]), device=device))
    return masks, f.reshape(2 ** M, bg.shape[0]).double().mean(1).cpu().numpy()


def brute_force_exact(tables, x, bg, device):
    """Interventional Shapley values of the ensemble's margin at ``x`` by
    enumerating all 2^12 group coalitions (:func:`coalition_values`), the
    Shapley sum in float64."""

    from math import factorial

    masks, v = coalition_values(tables, x, bg, device)
    M = masks.shape[1]
    size = masks.sum(1)
    phi = np.zeros(M)
    for j in range(M):
        without = ~masks[:, j]
        s = size[without]
        w = np.array([factorial(k) * factorial(M - k - 1) / factorial(M) for k in s])
        phi[j] = np.sum(w * (v[np.flatnonzero(without) | (1 << j)] - v[without]))
    return phi


def brute_force_interactions(tables, x, bg, device):
    """The pairwise Shapley interaction index ``I (M, M)`` of the same game
    by enumeration: ``I_ij = Σ_{S ∌ i,j} |S|! (M-|S|-2)! / (M-1)! · (v(S+ij)
    − v(S+i) − v(S+j) + v(S))``, in float64 (zero diagonal)."""

    from math import factorial

    masks, v = coalition_values(tables, x, bg, device)
    M = masks.shape[1]
    size = masks.sum(1)
    I = np.zeros((M, M))
    for i in range(M):
        for j in range(i + 1, M):
            S = np.flatnonzero(~masks[:, i] & ~masks[:, j])
            w = np.array([factorial(k) * factorial(M - k - 2) / factorial(M - 1)
                          for k in size[S]])
            bi, bj = 1 << i, 1 << j
            I[i, j] = I[j, i] = np.sum(w * (v[S | bi | bj] - v[S | bi] - v[S | bj] + v[S]))
    return I


def bucket_inputs(explainer, X, device):
    """The ``exact_tree_phi`` inputs of each depth bucket of the packed
    route for ``X``, as the engine forms them: ``[(args, dmax), ...]``."""

    import torch
    from distributedkernelshap_tpu_torch.ops import treeshap

    eng = explainer._explainer
    consts = eng._exact_consts()
    packed, pred = consts["packed"], eng.predictor
    T, L, _ = pred.path_sign.shape
    M, B = eng.M, X.shape[0]
    bgw = consts["bgw"] / consts["bgw"].sum()
    with torch.no_grad():
        xo, xn = treeshap._x_reach(pred, torch.as_tensor(X, device=device), consts["G"],
                                   consts["reach"]["onpath_g"], 1 << 25)
    xo, xn = xo.reshape(B, T * L, M), xn.reshape(B, T * L, M)
    out = []
    for start, stop, dmax in consts["plan"].buckets:
        idx = packed["perm"][start:stop]
        args = tuple(a.contiguous() for a in (
            xo[:, idx], xn[:, idx], packed["z_ok"][:, start:stop],
            packed["z_dead"][:, start:stop].float(), packed["lv"][start:stop], bgw))
        out.append((args, int(dmax)))
    return out


def phi_bound_ms(args, sm_count, sm_clock_hz):
    """The least time the card could take for one ``exact_tree_phi`` call on
    these inputs: the larger of its bytes (each input read once, the output
    written once) over HBM bandwidth and its operations over the peak rate
    of their unit, per unit.  Operations, counted from the data: for every
    (b, p, n) triple whose path holds a group of the instance, 3 masked
    population counts (6 integer operations); for every live triple (alive,
    u + v > 0), the two weights (an f32 multiply each: the binomials'
    reciprocals are tabled, so no division is needed) and u + 1 f32 adds
    into the per-group sums (v is fixed per (b, p) on alive rows, so the
    x-not side is one sum)."""

    import torch

    xo, xn, zo, zd, lv, bgw = args
    B, P, M = xo.shape
    N, K = zo.shape[0], lv.shape[1]
    nz = 1.0 - zo
    u = torch.einsum("bpm,npm->bnp", xo, nz)
    v = torch.einsum("bpm,npm->bnp", xn, zo)
    dead = torch.einsum("bpm,npm->bnp", xn, nz)
    live = (dead < 0.5) & (zd[None] < 0.5) & (u + v > 0.5)
    on_path = int(((xo + xn).sum(-1) > 0.5).sum()) * N
    n_live = int(live.sum())
    adds = float((u + 1.0)[live].sum())
    nbytes = 4 * (2 * B * P * M + N * P * M + N * P + P * K + N + B * M * K)
    per_s = sm_count * sm_clock_hz
    times = {
        "bytes": nbytes / HBM_BYTES_PER_S,
        "operations": max(6 * on_path / (per_s * INT32_LANES_PER_SM),
                          (2 * n_live + adds) / (per_s * FP32_LANES_PER_SM)),
    }
    bound_by = max(times, key=times.get)
    return 1e3 * times[bound_by], bound_by, {"triples": B * P * N, "on_path": on_path,
                                              "live": n_live, "adds": adds}


def phi_edge_inputs(rng, B, P, N, M, K, device, kind="random", path_groups=None):
    """Random 0/1 ``exact_tree_phi`` inputs (disjoint x_only/x_not on each
    path's groups, normalised weights).  Each group lies on a path at a rate
    of 0.4, or (``path_groups``) each path holds between 1 and that many
    groups drawn from all M, as a tree path of that depth does.  ``kind``:
    ``"random"``; ``"all live"`` (each path's x-not groups are the same for
    every instance and lie in z_ok, z_dead = 0: every row is alive);
    ``"none live"`` (z_dead = 1 everywhere); ``"all on path"`` (every group
    on every path, x-only at a rate of 0.9 and instance 0 on all of them,
    z_ok drawn at a rate of U(0.2, 1) per row: the widest rank sets and many
    pairs)."""

    import torch

    x_ok = (rng.random((B, P, M)) < 0.6).astype(np.float32)
    if path_groups:
        onpath = np.zeros((P, M), np.float32)
        for p in range(P):
            width = int(rng.integers(1, min(path_groups, M) + 1))
            onpath[p, rng.choice(M, width, replace=False)] = 1.0
    else:
        onpath = (rng.random((P, M)) < 0.4).astype(np.float32)
    z_ok = (rng.random((N, P, M)) < 0.7).astype(np.float32)
    z_dead = (rng.random((N, P)) < 0.1).astype(np.float32)
    if kind == "all on path":
        onpath[:] = 1.0
        x_ok = (rng.random((B, P, M)) < 0.9).astype(np.float32)
        x_ok[0] = 1.0
        z_ok = (rng.random((N, P, M)) < rng.uniform(0.2, 1.0, (N, 1, 1))).astype(np.float32)
    x_only, x_not = x_ok * onpath, (1 - x_ok) * onpath
    if kind == "all live":
        not_p = (rng.random((P, M)) < 0.5).astype(np.float32) * onpath
        x_only = x_only * (1 - not_p)
        x_not = np.broadcast_to(not_p, (B, P, M)).copy()
        z_ok = np.maximum(z_ok, not_p[None])
        z_dead[:] = 0.0
    if kind == "none live":
        z_dead[:] = 1.0
    arrays = (x_only, x_not, z_ok, z_dead, rng.normal(size=(P, K)).astype(np.float32),
              (lambda w: w / w.sum())(rng.random(N).astype(np.float32) + 0.1))
    return tuple(torch.tensor(a, device=device) for a in arrays)


#: edge shapes both exact kernels are held to their plain versions at:
#: (name, (B, P, N, M, K, dmax), kind of phi_edge_inputs)
EXACT_EDGES = [
    ("ragged", (13, 77, 77, 6, 1, 6), "random"),
    ("N=300", (64, 300, 300, 12, 1, 12), "random"),
    ("dmax=1", (64, 256, 100, 12, 1, 1), "random"),
    ("K=3 M=40", (9, 50, 30, 40, 3, 40), "random"),
    ("M=16 K=2", (32, 200, 100, 16, 2, 16), "random"),
    ("M=24", (32, 200, 100, 24, 1, 10), "random"),
    ("all live", (64, 256, 100, 12, 2, 12), "all live"),
    ("none live", (64, 256, 100, 12, 1, 12), "none live"),
    ("N=1", (64, 256, 1, 12, 1, 12), "random"),
    ("N=130, not a multiple of the chunk", (32, 200, 130, 12, 1, 12), "random"),
    ("M=63 dmax=63 all on path", (16, 64, 40, 63, 1, 63), "all on path"),
    ("M=64 dmax=64 all on path", (16, 64, 40, 64, 1, 64), "all on path"),
]


#: edge shapes of exact_tree_inter's walk by path slot (from
#: ``INTER_SLOT_M`` groups), beside ``EXACT_EDGES``' M = dmax = 64 with every
#: group on path (2080 slot pairs, the most bands a path can need): a banded
#: width with classes and N past the chunk, and every row live or none at
#: M = 64
INTER_EDGES = [
    ("M=32 K=3 N=130", (64, 256, 130, 32, 3, 32), "random"),
    ("M=64 all live", (32, 128, 100, 64, 1, 64), "all live"),
    ("M=64 none live", (32, 128, 100, 64, 1, 64), "none live"),
]


def edge_cases(rng, device, edges=EXACT_EDGES):
    return [(name, phi_edge_inputs(rng, B, P, N, M, K, device, kind), dmax)
            for name, (B, P, N, M, K, dmax), kind in edges]


def beta_weight_inputs(D, device):
    """Inputs whose phi IS the Beta weights (see
    tests/test_torch_port_treeshap.py): instance b holds one (u, v) pair on
    one path, one background row, leaf value 1; groups 0..D-1 are x-only
    (z_ok = 0), D..2D-1 x-not (z_ok = 1)."""

    import torch

    pairs = [(u, v) for u in range(D + 1) for v in range(D + 1) if u + v > 0]
    M = 2 * D
    xo = np.zeros((len(pairs), 1, M), np.float32)
    xn = np.zeros_like(xo)
    for b, (u, v) in enumerate(pairs):
        xo[b, 0, :u] = 1.0
        xn[b, 0, D:D + v] = 1.0
    z_ok = np.zeros((1, 1, M), np.float32)
    z_ok[0, 0, D:] = 1.0
    arrays = (xo, xn, z_ok, np.zeros((1, 1), np.float32), np.ones((1, 1), np.float32),
              np.ones(1, np.float32))
    return tuple(torch.tensor(a, device=device) for a in arrays), np.array(pairs)


def live_triples(args, kind):
    """``(B, N, P)`` bool: the triples whose row a tile kernel's live mask
    keeps -- alive (z_dead clear, every x-not group in z_ok) and adding
    something: ``u + v > 0`` for ``"phi"``; for ``"inter"`` some pairwise
    weight nonzero (v >= 2, or u >= 1 with v >= 1, or u >= 2)."""

    import torch

    xo, xn, zo, zd, _, _ = args
    nz = 1.0 - zo
    u = torch.einsum("bpm,npm->bnp", xo, nz)
    v = torch.einsum("bpm,npm->bnp", xn, zo)
    alive = (torch.einsum("bpm,npm->bnp", xn, nz) < 0.5) & (zd[None] < 0.5)
    if kind == "phi":
        return alive & (u + v > 0.5)
    return alive & ((v > 1.5) | ((u > 0.5) & (v > 0.5)) | (u > 1.5))


def divergence(args, kind):
    """    how much predicated work the live-row masks remove, from the data:
    per (instance b, 32-path tile, chunk of ``EXACT_CHUNK_ROWS`` rows) -- one
    warp's walk over one staged chunk -- the rows where any lane is live (a
    body predicated per row runs on each), the most live rows of one lane
    (the trip count of a mask loop with one path per lane, as
    ``exact_tree_phi``'s) and the live triples (the steps of a warp-uniform
    walk over the warp's paths, as ``exact_tree_inter``'s), each summed over
    all warp-chunks."""

    import torch
    from distributedkernelshap_tpu_torch.ops.cuda_kernels import EXACT_CHUNK_ROWS as nc

    live = live_triples(args, kind)
    B, N, P = live.shape
    C, T = -(-N // nc), -(-P // 32)
    padded = torch.zeros((B, C * nc, T * 32), dtype=torch.bool, device=live.device)
    padded[:, :N, :P] = live
    per = padded.view(B, C, nc, T, 32)
    out = {"warp_chunks": B * C * T, "rows_staged": B * N * T,
           "rows_any_lane_live": int(per.any(-1).sum()),
           "max_lane_live_rows": int(per.sum(2).max(-1).values.sum()),
           "live_triples": int(live.sum()), "triples": B * N * P}
    out["body_steps_saved"] = 1.0 - out["max_lane_live_rows"] / max(1, out["rows_any_lane_live"])
    out["lane_use_in_body"] = out["live_triples"] / max(1, 32 * out["max_lane_live_rows"])
    return out


def print_divergence(label, args, kind):
    d = divergence(args, kind)
    print(f"divergence [{label}]: {d['warp_chunks']} warp-chunks, {d['rows_staged']} "
          f"staged rows; rows with any live lane (a predicated body runs) "
          f"{d['rows_any_lane_live']}; max-over-lanes live rows (the mask loop runs) "
          f"{d['max_lane_live_rows']} ({100 * d['body_steps_saved']:.1f}% fewer body "
          f"steps); live triples (the steps of a warp-uniform walk) "
          f"{d['live_triples']} of {d['triples']} "
          f"({100 * d['live_triples'] / d['triples']:.1f}%), lanes busy in the body "
          f"{100 * d['lane_use_in_body']:.1f}%", flush=True)
    return d


def tile_name(function: str) -> str:
    """``inter_tile_kernel<unsigned, 3>`` (or ``sigmoid_kernel<true>``)
    from a mangled kernel name."""

    import re

    m = re.search(r"\d+([a-z_]+_kernel[a-z_]*)(I((?:j|y|Li\d+E|Lb[01]E)+)E)?", function)
    if not m:
        return function
    if not m.group(2):
        return m.group(1)
    names = {"j": "unsigned", "y": "u64", "Lb0E": "false", "Lb1E": "true"}
    args = [names.get(t, t[2:-1]) for t in re.findall(r"j|y|Li\d+E|Lb[01]E", m.group(3))]
    return f"{m.group(1)}<{', '.join(args)}>"


def exact_kernel_report(libs):
    """Each exact kernel's build report (registers, static shared memory,
    spills per kernel function, from the ``.log`` beside its library) and
    what its tile kernel takes at the Adult width (M = 12), at M = 63, at
    the widest group word (M = 64) and by path slot (``exact_tree_phi`` at
    M = 100, ``exact_tree_inter`` from ``INTER_SLOT_M``): dynamic shared
    memory and resident blocks per SM."""

    from distributedkernelshap_tpu_torch.ops import cuda_kernels

    for name in ("exact_tree_phi", "exact_tree_inter"):
        log = libs[name].with_name(libs[name].name + ".log")
        rows = cuda_kernels.ptxas_report(log.read_text() if log.exists() else "")
        for r in rows:
            print(f"  ptxas {name}: {tile_name(r['function'])}: {r.get('registers')} "
                  f"registers, {r.get('smem_bytes')} B static smem, "
                  f"{r.get('stack_bytes')} B stack, spill stores "
                  f"{r.get('spill_stores')} B, spill loads {r.get('spill_loads')} B",
                  flush=True)
        if not any("tile_kernel" in r["function"] for r in rows):
            raise AssertionError(f"no ptxas report for {name}'s tile kernels in {log}")
        for M in (12, 63, 64) + ((M_WIDE,) if name == "exact_tree_phi"
                                 else (cuda_kernels.INTER_SLOT_M,)):
            print(f"  {name} tile kernel at M={M}: "
                  f"{cuda_kernels.tile_kernel_info(name, M)}", flush=True)


def tile_report(name, function, M, K):
    """Print what the tile kernel ``function`` (e.g. ``"inter_slot_kernel<u64,
    true>"``) of ``csrc/<name>.cu`` took at its build (registers, spills,
    from the ``.log`` beside the library) and takes on the card at ``M``
    groups and ``K`` classes (dynamic shared memory, blocks per SM); raises
    where the build report lacks it."""

    from distributedkernelshap_tpu_torch.ops import cuda_kernels

    lib = cuda_kernels.library_path(name)
    log = lib.with_name(lib.name + ".log")
    rows = [r for r in cuda_kernels.ptxas_report(log.read_text() if log.exists() else "")
            if tile_name(r["function"]) == function]
    if not rows:
        raise AssertionError(f"no ptxas report for {function} in {log}")
    r = rows[0]
    print(f"{function} ({name}) at M={M} K={K}: {r.get('registers')} registers, spill "
          f"stores {r.get('spill_stores')} B, spill loads {r.get('spill_loads')} B, "
          f"{r.get('stack_bytes')} B stack; {cuda_kernels.tile_kernel_info(name, M, K)}",
          flush=True)


def compare_exact_kernel(buckets, seed, device):
    """Phase 7a: ``exact_tree_phi`` against its plain version on the card at
    the main path's bucket inputs and at edge shapes; bit-identical
    repeats; the Beta weights against the f64 table."""

    import torch
    from distributedkernelshap_tpu_torch.ops.cuda_kernels import (
        exact_tree_phi,
        exact_tree_phi_plain,
    )
    from distributedkernelshap_tpu_torch.ops.treeshap import _beta_tables

    rng = np.random.default_rng([seed, 11])
    cases = [(f"bucket {i} dmax={d}", a, d) for i, (a, d) in enumerate(buckets)]
    cases += edge_cases(rng, device)
    worst = 0.0
    for name, args, dmax in cases:
        got = exact_tree_phi(*args, dmax=dmax)
        again = exact_tree_phi(*args, dmax=dmax)
        ref = exact_tree_phi_plain(*args, dmax=dmax)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        tol = phi_tol(ref.cpu().numpy())
        same = bool(torch.equal(got, again))
        print(f"exact_tree_phi vs plain [{name}] shape B,P,N,M,K="
              f"{tuple(args[0].shape[:2]) + (args[2].shape[0], args[0].shape[2], args[4].shape[1])}"
              f" dmax={dmax}: max_abs_diff={err:.3e} (tol {tol:.2e}), bit-identical "
              f"repeat={same}", flush=True)
        if not (bool(got.isfinite().all()) and err <= tol and same):
            raise AssertionError(f"exact_tree_phi disagrees with its plain version or "
                                 f"with itself at {name}")
        worst = max(worst, err)
    D = 31
    args, pairs = beta_weight_inputs(D, device)
    phi = exact_tree_phi(*args, dmax=2 * D)[:, :, 0].cpu().numpy()
    wp_t, wm_t = _beta_tables(2 * D)
    u, v = pairs.T
    rel = max(float(np.max(np.abs(phi[u > 0, 0] / wp_t[u[u > 0], v[u > 0]] - 1))),
              float(np.max(np.abs(-phi[v > 0, D] / wm_t[u[v > 0], v[v > 0]] - 1))))
    print(f"exact_tree_phi Beta weights on the card vs the f64 table, u + v <= {2 * D}: "
          f"max rel err {rel:.3e} (tol 5e-5)", flush=True)
    if not rel <= 5e-5:
        raise AssertionError("exact_tree_phi's Beta weights miss the f64 table")
    return worst


def exact_phase(tables, X_all, bg, device, sm_count, sm_clock_hz, card, seed):
    """Phases 6 and 7: the exact TreeSHAP path, counted, checked and timed.
    Returns the kernel's JSON record."""

    import torch
    from distributedkernelshap_tpu_torch.ops.cuda_kernels import (
        exact_tree_phi,
        exact_tree_phi_plain,
    )
    from distributedkernelshap_tpu_torch.ops.explain import groups_to_matrix
    from distributedkernelshap_tpu_torch.ops.treeshap import (
        build_packed_plan,
        resolve_pack_paths,
    )

    X = X_all[:B_EXACT]
    plan = build_packed_plan(tree_predictor(tables, "cpu"),
                             groups_to_matrix(adult_groups(), X.shape[1]))
    auto_packs = resolve_pack_paths(None, plan)
    print(f"exact: seeded Adult-shaped GBT, T={N_TREES}, depth {tables['depth']}, "
          f"plan: live paths {plan.n_live}, gain {plan.gain:.3f}, buckets {plan.buckets} "
          f"(Pp={plan.n_packed}); auto route: {'packed' if auto_packs else 'dense'}",
          flush=True)
    # the packed route is the main path; force it if the auto rule keeps dense
    pack = None if auto_packs else True
    if not auto_packs:
        print("exact: the auto rule keeps this ensemble dense; the packed run "
              "forces pack_paths=True", flush=True)
    runs = {}
    for route, pack_paths, want in (("packed", pack, len(plan.buckets)),
                                    ("dense", False, 1)):
        exact_tree_phi.launches = 0
        explainer, expl = explain_exact(tables, X, bg, device, pack_paths=pack_paths)
        torch.cuda.synchronize()
        launches = exact_tree_phi.launches
        path = explainer.kernel_path
        print(f"exact {route} route: launches exact_tree_phi={launches} (want {want}), "
              f"kernel_path={path}", flush=True)
        packed_on = explainer._explainer._exact_consts()["packed"] is not None
        if launches != want or path != {"exact_phi": "cuda"} or packed_on != (route == "packed"):
            raise AssertionError(f"the exact {route} explain did not go through "
                                 "exact_tree_phi as planned")
        phi, add_err = exact_phi(expl, B_EXACT)
        phi_again, _ = exact_phi(explainer.explain(X, nsamples="exact", silent=True), B_EXACT)
        _, expl_plain = explain_exact(tables, X, bg, device, pack_paths=pack_paths,
                                      use_kernel=False)
        d_plain = float(np.abs(phi - exact_phi(expl_plain, B_EXACT)[0]).max())
        _, expl_cpu = explain_exact(tables, X[:N_CPU_ROWS], bg, "cpu", pack_paths=pack_paths)
        d_cpu = float(np.abs(phi[:N_CPU_ROWS] - exact_phi(expl_cpu, N_CPU_ROWS)[0]).max())
        tol = phi_tol(phi)
        bitwise = bool(np.array_equal(phi, phi_again))
        print(f"exact {route} route: additivity={add_err:.3e} (< {EXACT_ADDITIVITY:g}); "
              f"|phi kernel - phi plain route|={d_plain:.3e}, |phi card - phi cpu| "
              f"(first {N_CPU_ROWS} rows)={d_cpu:.3e} (tol {tol:.2e}); repeat "
              f"bit-identical={bitwise}; max|phi|={np.abs(phi).max():.4f}", flush=True)
        if not (d_plain <= tol and d_cpu <= tol and bitwise):
            raise AssertionError(f"the exact {route} explain disagrees with its references")
        runs[route] = (explainer, phi, launches)
    packed_explainer, phi_packed, launches = runs["packed"]
    d_routes = float(np.abs(phi_packed - runs["dense"][1]).max())
    bg10 = bg[:10]
    _, expl_bf = explain_exact(tables, X[:2], bg10, device, pack_paths=pack)
    bf = np.stack([brute_force_exact(tables, X[i], bg10, device) for i in range(2)])
    d_bf = float(np.abs(np.asarray(expl_bf.shap_values[0]) - bf).max())
    print(f"exact: |phi packed - phi dense|={d_routes:.3e}; |phi - brute-force Shapley| "
          f"(2 rows, 10 background rows, 4096 coalitions)={d_bf:.3e} (tol {phi_tol(bf):.2e})",
          flush=True)
    if not (d_routes <= phi_tol(phi_packed) and d_bf <= phi_tol(bf)):
        raise AssertionError("the exact routes disagree with each other or with "
                             "brute-force Shapley values")

    # 7. kernel vs plain at the main path's inputs and edges, then times
    buckets = bucket_inputs(packed_explainer, X, device)
    max_err = compare_exact_kernel(buckets, seed, device)
    for i, (args, dmax) in enumerate(buckets):
        print_divergence(f"exact_tree_phi, bucket {i} dmax={dmax}", args, "phi")
    walls = {}
    for B in (B_EXACT, B_EXACT_BIG):
        Xb = X_all[:B]
        packed_explainer.explain(Xb, nsamples="exact", silent=True)
        runs_s = []
        for _ in range(3):
            t0 = time.perf_counter()
            packed_explainer.explain(Xb, nsamples="exact", silent=True)
            torch.cuda.synchronize()
            runs_s.append(time.perf_counter() - t0)
        walls[B] = (1e3 * statistics.median(runs_s), [round(1e3 * w, 3) for w in runs_s])
    kernel_ms = plain_ms = bound_ms = 0.0
    bound_parts = []
    for (args, dmax), (start, stop, _) in zip(buckets, packed_explainer._explainer
                                               ._exact_consts()["plan"].buckets):
        k_ms = cuda_time_ms(lambda: exact_tree_phi(*args, dmax=dmax), 50)
        p_ms = cuda_time_ms(lambda: exact_tree_phi_plain(*args, dmax=dmax), 5)
        b_ms, b_by, counts = phi_bound_ms(args, sm_count, sm_clock_hz)
        print(f"exact_tree_phi bucket [{start}:{stop}) dmax={dmax} at B={B_EXACT} "
              f"P={stop - start} N={args[2].shape[0]} M={args[0].shape[2]} K=1: kernel "
              f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); "
              f"counts {counts}", flush=True)
        kernel_ms += k_ms
        plain_ms += p_ms
        bound_ms += b_ms
        bound_parts.append(b_by)
    bound_by = max(set(bound_parts), key=bound_parts.count)
    print(f"times on {card}: exact explain wall median of 3 = {walls[B_EXACT][0]:.3f} ms "
          f"at B={B_EXACT} (runs {walls[B_EXACT][1]}), {walls[B_EXACT_BIG][0]:.3f} ms at "
          f"B={B_EXACT_BIG} (runs {walls[B_EXACT_BIG][1]}); exact_tree_phi per explain "
          f"at B={B_EXACT} ({len(buckets)} launches): kernel {kernel_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
          f"{100 * bound_ms / kernel_ms:.1f}% of bound; library_ms null: no single "
          f"PyTorch call computes this function", flush=True)
    return {"name": "exact_tree_phi", "route": "cuda",
            "source": "distributedkernelshap_tpu_torch/csrc/exact_tree_phi.cu",
            "replaces": "distributedkernelshap_tpu/ops/pallas_kernels.py:262",
            "launches": launches, "max_abs_err": max_err, "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


# ---------------------------------------------------------------------- #
# exact Shapley interactions (exact_tree_inter)


def interaction_values(expl, B, M=len(ADULT_WIDTHS)):
    """The explanation's interaction matrices ``(B, M, M)``, checked:
    finite, symmetric and with rows summing to the shap values (1e-5)."""

    inter = np.asarray(expl.data["raw"]["interaction_values"][0])
    phi = np.asarray(expl.shap_values[0])
    if inter.shape != (B, M, M) or not np.isfinite(inter).all():
        raise AssertionError(f"bad interaction values: shape {inter.shape}, "
                             f"finite={np.isfinite(inter).all()}")
    sym = float(np.abs(inter - inter.transpose(0, 2, 1)).max())
    rows = float(np.abs(inter.sum(-1) - phi).max())
    if not (sym <= CONVENTION_ATOL and rows <= CONVENTION_ATOL):
        raise AssertionError(f"interaction matrices break the shap convention: "
                             f"asymmetry {sym}, |row sums - phi| {rows}")
    return inter, sym, rows


def dense_inputs(explainer, X, device):
    """The ``exact_tree_inter`` inputs of the interaction explain for ``X``,
    as the engine forms them on the dense layout: ``(args, dmax)``."""

    import torch
    from distributedkernelshap_tpu_torch.ops import treeshap

    eng = explainer._explainer
    consts = eng._exact_consts()
    with torch.no_grad():
        args, dmax = treeshap._dense_inputs(
            eng.predictor, torch.as_tensor(X, device=device), eng._exact_full_reach(),
            consts["G"], eng.config.shap.target_chunk_elems)
    return treeshap._kernel_args(*args, consts["bgw"] / consts["bgw"].sum()), dmax


def inter_bound_ms(args, sm_count, sm_clock_hz):
    """The least time the card could take for one ``exact_tree_inter`` call
    on these inputs: the larger of its bytes (each input read once, the
    ``(B, M, M, K)`` output written once) over HBM bandwidth and its
    operations over the peak rate of their unit.  Operations, counted from
    the data: for every (b, p, n) triple whose path holds a group of the
    instance, 3 masked population counts (6 integer operations); for every
    alive triple, one f32 multiply each for W_uu (u >= 2), W_uv (u, v >= 1)
    and W_vv (v >= 2) (the binomials' reciprocals are tabled, so no
    division is needed); and the f32 adds into the pair sums: u(u+1)/2 for
    the UU triangle (u >= 2; the block is symmetric), u for the UV sums
    (u, v >= 1) and one for the VV sum (v >= 2)."""

    import torch

    xo, xn, zo, zd, lv, bgw = args
    B, P, M = xo.shape
    N, K = zo.shape[0], lv.shape[1]
    nz = 1.0 - zo
    u = torch.einsum("bpm,npm->bnp", xo, nz)
    v = torch.einsum("bpm,npm->bnp", xn, zo)
    dead = torch.einsum("bpm,npm->bnp", xn, nz)
    alive = (dead < 0.5) & (zd[None] < 0.5)
    uu, uv, vv = alive & (u > 1.5), alive & (u > 0.5) & (v > 0.5), alive & (v > 1.5)
    live = uu | uv | vv
    on_path = int(((xo + xn).sum(-1) > 0.5).sum()) * N
    multiplies = float(uu.sum() + uv.sum() + vv.sum())
    adds = float((u * (u + 1.0) / 2.0)[uu].sum() + u[uv].sum() + vv.sum())
    nbytes = 4 * (2 * B * P * M + N * P * M + N * P + P * K + N + B * M * M * K)
    per_s = sm_count * sm_clock_hz
    times = {
        "bytes": nbytes / HBM_BYTES_PER_S,
        "operations": max(6 * on_path / (per_s * INT32_LANES_PER_SM),
                          (multiplies + adds) / (per_s * FP32_LANES_PER_SM)),
    }
    bound_by = max(times, key=times.get)
    return 1e3 * times[bound_by], bound_by, {
        "triples": B * P * N, "on_path": on_path, "live": int(live.sum()),
        "multiplies": multiplies, "adds": adds, "bytes": nbytes}


def raw_close(got, ref):
    """``(max |got - ref|, within atol/rtol RAW_TOL)``."""

    diff = (got - ref).abs()
    return float(diff.max()), bool((diff <= RAW_TOL + RAW_TOL * ref.abs()).all())


def compare_inter_kernel(dense, seed, device):
    """Phase 9a: ``exact_tree_inter`` against its plain version on the card
    at the main path's dense inputs and at edge shapes; bit-identical
    repeats; the interaction weights against the f64 table."""

    import torch
    from distributedkernelshap_tpu_torch.ops.cuda_kernels import (
        exact_tree_inter,
        exact_tree_inter_plain,
    )
    from distributedkernelshap_tpu_torch.ops.treeshap import _interaction_tables

    rng = np.random.default_rng([seed, 13])
    cases = [("dense main path", *dense)] + edge_cases(rng, device)
    cases += edge_cases(rng, device, INTER_EDGES)
    worst = 0.0
    for name, args, dmax in cases:
        got = exact_tree_inter(*args, dmax=dmax)
        again = exact_tree_inter(*args, dmax=dmax)
        ref = exact_tree_inter_plain(*args, dmax=dmax)
        torch.cuda.synchronize()
        err, close = raw_close(got, ref)
        same = bool(torch.equal(got, again))
        print(f"exact_tree_inter vs plain [{name}] shape B,P,N,M,K="
              f"{tuple(args[0].shape[:2]) + (args[2].shape[0], args[0].shape[2], args[4].shape[1])}"
              f" dmax={dmax}: max_abs_diff={err:.3e} (atol = rtol = {RAW_TOL:g}: {close}), "
              f"bit-identical repeat={same}", flush=True)
        if not (bool(got.isfinite().all()) and close and same):
            raise AssertionError(f"exact_tree_inter disagrees with its plain version or "
                                 f"with itself at {name}")
        worst = max(worst, err)
    D = 31
    args, pairs = beta_weight_inputs(D, device)   # raw sum = the pairwise weights
    inter = exact_tree_inter(*args, dmax=2 * D)[..., 0].cpu().numpy()
    w_uu, w_vv, w_uv = _interaction_tables(2 * D)
    u, v = pairs.T
    rel = 0.0
    for got, table, sel in ((inter[:, 0, 1], w_uu, u >= 2),
                            (inter[:, 0, D], w_uv, (u >= 1) & (v >= 1)),
                            (inter[:, D, D + 1], w_vv, v >= 2)):
        rel = max(rel, float(np.max(np.abs(got[sel] / table[u[sel], v[sel]] - 1))))
    print(f"exact_tree_inter weights W_uu, W_uv, W_vv on the card vs the f64 table, "
          f"u + v <= {2 * D}: max rel err {rel:.3e} (tol 5e-5)", flush=True)
    if not rel <= 5e-5:
        raise AssertionError("exact_tree_inter's weights miss the f64 table")
    return worst


def inter_phase(tables, X_all, bg, device, sm_count, sm_clock_hz, card, seed):
    """Phases 8 and 9: the exact interaction path, counted, checked and
    timed, its dense ``exact_tree_phi`` launch too.  Returns the
    ``exact_tree_inter`` JSON record and that phi launch's max |kernel -
    plain|."""

    import torch
    from distributedkernelshap_tpu_torch.ops.cuda_kernels import (
        exact_tree_inter,
        exact_tree_inter_plain,
        exact_tree_phi,
        exact_tree_phi_plain,
    )

    X = X_all[:B_EXACT]
    # 8. the main path, counted: pack_paths at its auto value
    exact_tree_inter.launches = exact_tree_phi.launches = 0
    explainer, expl = explain_exact(tables, X, bg, device, interactions=True)
    torch.cuda.synchronize()
    launches, phi_launches = exact_tree_inter.launches, exact_tree_phi.launches
    path = explainer.kernel_path
    eng = explainer._explainer
    packed = eng._exact_consts()["packed"] is not None
    rebuilt = ("exact_reach_full", eng.content_fingerprint()) in eng._plan_consts_cache
    print(f"interactions: launches exact_tree_inter={launches} (want 1), exact_tree_phi="
          f"{phi_launches} (want 1, dense), kernel_path={path}; phi constants packed="
          f"{packed}, dense reach rebuilt for the pairs={rebuilt}", flush=True)
    if launches != 1 or phi_launches != 1 or path != {"exact_phi": "cuda",
                                                      "exact_inter": "cuda"}:
        raise AssertionError("the interaction explain did not go through "
                             "exact_tree_inter and exact_tree_phi as planned")
    if packed != rebuilt:
        raise AssertionError("the interaction explain did not rebuild the dense reach")
    inter, sym, rows = interaction_values(expl, B_EXACT)
    again, _, _ = interaction_values(
        explainer.explain(X, nsamples="exact", silent=True, interactions=True), B_EXACT)
    _, expl_plain = explain_exact(tables, X, bg, device, use_kernel=False, interactions=True)
    d_plain = float(np.abs(inter - interaction_values(expl_plain, B_EXACT)[0]).max())
    _, expl_cpu = explain_exact(tables, X[:N_CPU_ROWS], bg, "cpu", interactions=True)
    d_cpu = float(np.abs(inter[:N_CPU_ROWS]
                         - interaction_values(expl_cpu, N_CPU_ROWS)[0]).max())
    tol = phi_tol(inter)
    bitwise = bool(np.array_equal(inter, again))
    print(f"interactions: shape {inter.shape}, asymmetry {sym:.3e}, |row sums - phi| "
          f"{rows:.3e} (tol {CONVENTION_ATOL:g}); |kernel - plain route|={d_plain:.3e}, "
          f"|card - cpu| (first {N_CPU_ROWS} rows)={d_cpu:.3e} (tol {tol:.2e}); repeat "
          f"bit-identical={bitwise}; max|inter|={np.abs(inter).max():.4f}", flush=True)
    if not (d_plain <= tol and d_cpu <= tol and bitwise):
        raise AssertionError("the interaction explain disagrees with its references")
    bg10 = bg[:10]
    _, expl_bf = explain_exact(tables, X[:2], bg10, device, interactions=True)
    got_bf = interaction_values(expl_bf, 2)[0]
    half = np.stack([brute_force_interactions(tables, X[i], bg10, device) / 2.0
                     for i in range(2)])
    off = ~np.eye(len(ADULT_WIDTHS), dtype=bool)
    d_bf = float(np.abs(got_bf[:, off] - half[:, off]).max())
    print(f"interactions: |off-diagonal - brute-force interaction index / 2| (2 rows, "
          f"10 background rows, 4096 coalitions)={d_bf:.3e} (tol {phi_tol(half):.2e})",
          flush=True)
    if not d_bf <= phi_tol(half):
        raise AssertionError("the interaction matrices miss the brute-force index")

    # 9. kernel vs plain at the main path's inputs and edges, then times
    args, dmax = dense_inputs(explainer, X, device)
    max_err = compare_inter_kernel((args, dmax), seed, device)
    print_divergence("exact_tree_inter, dense main path", args, "inter")
    print_divergence("exact_tree_phi, interaction path, dense", args, "phi")
    # the path's dense exact_tree_phi launch (the same inputs), held alone
    phi_got = exact_tree_phi(*args, dmax=dmax)
    phi_again = exact_tree_phi(*args, dmax=dmax)
    phi_ref = exact_tree_phi_plain(*args, dmax=dmax)
    torch.cuda.synchronize()
    phi_err = float((phi_got - phi_ref).abs().max())
    tol = phi_tol(phi_ref.cpu().numpy())
    same = bool(torch.equal(phi_got, phi_again))
    print(f"exact_tree_phi vs plain [interaction path, dense] shape B,P,N,M,K="
          f"{tuple(args[0].shape[:2]) + (args[2].shape[0], args[0].shape[2], args[4].shape[1])}"
          f" dmax={dmax}: max_abs_diff={phi_err:.3e} (tol {tol:.2e}), bit-identical "
          f"repeat={same}", flush=True)
    if not (bool(phi_got.isfinite().all()) and phi_err <= tol and same):
        raise AssertionError("the interaction path's dense exact_tree_phi disagrees "
                             "with its plain version or with itself")
    walls = {}
    for B in (B_EXACT, B_EXACT_BIG):
        Xb = X_all[:B]
        explainer.explain(Xb, nsamples="exact", silent=True, interactions=True)
        runs_s = []
        for _ in range(3):
            t0 = time.perf_counter()
            explainer.explain(Xb, nsamples="exact", silent=True, interactions=True)
            torch.cuda.synchronize()
            runs_s.append(time.perf_counter() - t0)
        walls[B] = (1e3 * statistics.median(runs_s), [round(1e3 * w, 3) for w in runs_s])
    kernel_ms = cuda_time_ms(lambda: exact_tree_inter(*args, dmax=dmax), 20)
    plain_ms = cuda_time_ms(lambda: exact_tree_inter_plain(*args, dmax=dmax), 3)
    bound_ms, bound_by, counts = inter_bound_ms(args, sm_count, sm_clock_hz)
    phi_ms = cuda_time_ms(lambda: exact_tree_phi(*args, dmax=dmax), 20)
    phi_plain_ms = cuda_time_ms(lambda: exact_tree_phi_plain(*args, dmax=dmax), 3)
    phi_b_ms, phi_b_by, phi_counts = phi_bound_ms(args, sm_count, sm_clock_hz)
    print(f"times on {card}: the interaction path's dense exact_tree_phi at B={B_EXACT} "
          f"P={args[0].shape[1]} N={args[2].shape[0]} M={args[0].shape[2]} K=1 "
          f"dmax={dmax}: kernel {phi_ms:.4f} ms, plain {phi_plain_ms:.4f} ms, bound "
          f"{phi_b_ms:.4f} ms ({phi_b_by}), {100 * phi_b_ms / phi_ms:.1f}% of bound; "
          f"counts {phi_counts}", flush=True)
    print(f"times on {card}: interaction explain wall median of 3 = {walls[B_EXACT][0]:.3f} "
          f"ms at B={B_EXACT} (runs {walls[B_EXACT][1]}), {walls[B_EXACT_BIG][0]:.3f} ms at "
          f"B={B_EXACT_BIG} (runs {walls[B_EXACT_BIG][1]}); exact_tree_inter at B={B_EXACT} "
          f"P={args[0].shape[1]} N={args[2].shape[0]} M={args[0].shape[2]} K=1 dmax={dmax}: "
          f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}), {100 * bound_ms / kernel_ms:.1f}% of bound; counts {counts}; "
          f"library_ms null: no single PyTorch call computes this function", flush=True)
    return {"name": "exact_tree_inter", "route": "cuda",
            "source": "distributedkernelshap_tpu_torch/csrc/exact_tree_inter.cu",
            "replaces": "distributedkernelshap_tpu/ops/pallas_kernels.py:440",
            "launches": launches, "max_abs_err": max_err, "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}, phi_err


# ---------------------------------------------------------------------- #
# the sampled engine: packed copy, l1 selection, plan constants, importance


def median_wall_ms(fn, reps: int):
    """``fn()`` once to warm up, then the median of ``reps`` host-clock
    walls ending in a device synchronise, in ms, with the runs."""

    import torch

    fn()
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        runs.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(runs), [round(r, 3) for r in runs]


def packed_transfer_phase(explainer, expl, X, bg, est, device):
    """Phase 10: the engine brings phi, E[f] and f(x) back in one copy,
    bit-identical to the explain function's outputs copied one by one; with
    ``transfer_dtype='float16'`` only phi is rounded."""

    import torch

    engine = explainer._explainer
    plan = engine._plan(None)
    copies = []
    cpu = torch.Tensor.cpu
    torch.Tensor.cpu = lambda t, *a, **k: copies.append(tuple(t.shape)) or cpu(t, *a, **k)
    try:
        got = engine._dispatch_array(X, plan)()
    finally:
        torch.Tensor.cpu = cpu
    Xp, B = engine._pad_to_bucket(X)
    out = engine._fn()(torch.as_tensor(Xp, device=device), *engine._device_args(plan))
    three = {"shap_values": out["shap_values"][:B].cpu().numpy(),
             "expected_value": out["expected_value"].cpu().numpy(),
             "raw_prediction": out["raw_prediction"][:B].cpu().numpy()}
    same = {k: bool(np.array_equal(got[k], three[k])) for k in three}
    print(f"packed transfer: {len(copies)} device-to-host copy per explain at B={B} "
          f"(shape {copies}); bit-identical to three copies: {same}", flush=True)
    if len(copies) != 1 or not all(same.values()):
        raise AssertionError("the packed result differs from the explain function's outputs")
    _, expl16 = explain_headline(X, bg, est, device, transfer_dtype="float16")
    phi, phi16 = np.stack(expl.shap_values, 1), np.stack(expl16.shap_values, 1)
    d16 = float(np.abs(phi16 - phi).max())
    within = bool(np.allclose(phi16, phi, atol=F16_ATOL, rtol=F16_RTOL))
    e_same = bool(np.array_equal(expl16.expected_value, expl.expected_value))
    fx_same = bool(np.array_equal(expl16.data["raw"]["raw_prediction"],
                                  expl.data["raw"]["raw_prediction"]))
    print(f"packed transfer float16: max|phi16 - phi32|={d16:.3e} (atol {F16_ATOL:g}, rtol "
          f"{F16_RTOL:g}: {within}); E[f] bit-identical {e_same}, f(x) bit-identical "
          f"{fx_same}; additivity {additivity(expl16):.3e}", flush=True)
    if not (within and e_same and fx_same):
        raise AssertionError("the float16 transfer changed more than phi's rounding")


def _selected(phi):
    """Each (instance, class) target's selected groups: the nonzero entries
    before the last, which takes the additivity remainder."""

    return [tuple(np.flatnonzero(r[:-1])) for r in phi.reshape(-1, phi.shape[-1])]


def l1_phase(X_all, bg, est, device, card):
    """Phase 11: the default explain of the 48 one-hot columns, ungrouped,
    runs the 'auto' → AIC selection; its device pass launches
    ``fused_linear_ey``, which is held against its plain version on the
    inputs that pass gave it.  Checked for additivity and against the port
    on the CPU on the first rows; the wall split into the first explain
    pass, the l1 device pass with its ``ey_adj`` copy, and the host
    selection and re-solve.  Returns the kernel's largest difference from
    its plain version."""

    import logging

    import torch
    from distributedkernelshap_tpu_torch import KernelShap
    from distributedkernelshap_tpu_torch import kernel_shap as ks_mod
    from distributedkernelshap_tpu_torch.ops import explain as explain_mod
    from distributedkernelshap_tpu_torch.ops.cuda_kernels import (
        fused_linear_ey,
        fused_linear_ey_plain,
    )

    X = X_all[:B_L1]
    explainer = KernelShap(est.predict_proba, link="logit", seed=0, device=device).fit(bg)
    engine = explainer._explainer
    warnings = []

    class Recorder(logging.Handler):
        def emit(self, record):
            warnings.append(record.getMessage())

    stamps = {}
    l1_solve, select = engine._l1_solve, ks_mod._l1_select_batch

    def timed_l1_solve(*a, **k):
        stamps["l1"] = time.perf_counter()
        return l1_solve(*a, **k)

    def timed_select(*a, **k):
        stamps["select"] = time.perf_counter()
        return select(*a, **k)

    ey_calls = []

    def recorded_ey(*a, **k):
        ey_calls.append((a, k))
        return fused_linear_ey(*a, **k)

    handler = Recorder(level=logging.WARNING)
    ks_mod.logger.addHandler(handler)
    engine._l1_solve, ks_mod._l1_select_batch = timed_l1_solve, timed_select
    explain_mod.fused_linear_ey = recorded_ey
    fused_linear_ey.launches = 0
    try:
        t0 = time.perf_counter()
        expl = explainer.explain(X, silent=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    finally:
        ks_mod.logger.removeHandler(handler)
        del engine._l1_solve
        ks_mod._l1_select_batch = select
        explain_mod.fused_linear_ey = fused_linear_ey
    launches, path = fused_linear_ey.launches, explainer.kernel_path
    S = engine._plan(None).n_rows
    # the kernel against its plain version on the l1 device pass's own
    # inputs (the last call: the with_ey pass), this plan's mask included
    (a, k), = ey_calls[-1:]
    if not np.array_equal(a[4].cpu().numpy(), l1_plan_mask()):
        raise AssertionError("the l1 device pass did not sample the default plan")
    got, ref = fused_linear_ey(*a, **k), fused_linear_ey_plain(*a, **k)
    ey_err = float((got - ref).abs().max())
    print(f"kernel vs plain [l1 device pass, its own inputs] XWg {tuple(a[0].shape)} mask "
          f"{tuple(a[4].shape)}: max_abs_diff={ey_err:.3e} (tol {EY_ATOL:g}); "
          f"{len(ey_calls)} kernel calls in the explain", flush=True)
    if not (bool(got.isfinite().all()) and ey_err <= EY_ATOL):
        raise AssertionError(f"fused_linear_ey disagrees with its plain version on the "
                             f"l1 device pass: {ey_err}")
    auto = [w for w in warnings if "l1_reg='auto'" in w]
    print(f"l1: ungrouped Adult-shaped rows B={B_L1} M={engine.M} K=2 S={S}, default "
          f"l1_reg: launches fused_linear_ey={launches}, kernel_path={path}; 'auto' -> AIC "
          f"warning: {bool(auto)}; degenerate fallbacks logged: "
          f"{sum('degenerate' in w for w in warnings)}", flush=True)
    if launches < 2 or path.get("ey") != "cuda" or not auto:
        raise AssertionError("the l1 explain did not run the AIC selection through "
                             "fused_linear_ey")
    phi = np.stack(expl.shap_values, 1)
    if phi.shape != (B_L1, 2, engine.M) or not np.isfinite(phi).all():
        raise AssertionError(f"bad l1 shap values: shape {phi.shape}")
    add_err = additivity(expl)
    expl_cpu = KernelShap(est.predict_proba, link="logit", seed=0, device="cpu").fit(
        bg).explain(X[:N_L1_CPU], silent=True)
    phi_cpu = np.stack(expl_cpu.shap_values, 1)
    same = np.array([a == b for a, b in zip(_selected(phi[:N_L1_CPU]), _selected(phi_cpu))])
    d_phi = float(np.abs(phi[:N_L1_CPU] - phi_cpu).reshape(-1, engine.M)[same].max())
    print(f"l1: additivity={add_err:.3e} (< {ADDITIVITY:g}); card vs cpu (first {N_L1_CPU} "
          f"rows): {same.mean():.4f} of {same.size} targets select the same set (>= "
          f"{L1_SHARE}), max|dphi| on them {d_phi:.3e} (tol {PHI_ATOL:g}); mean selected "
          f"groups {np.mean([len(t) for t in _selected(phi)]):.2f} of {engine.M - 1}",
          flush=True)
    if not (add_err < ADDITIVITY and same.mean() >= L1_SHARE and d_phi <= PHI_ATOL):
        raise AssertionError("the l1 explain disagrees with its references")
    first, device_pass, host = (1e3 * (stamps["l1"] - t0),
                                1e3 * (stamps["select"] - stamps["l1"]),
                                1e3 * (t1 - stamps["select"]))
    print(f"times on {card}: l1 explain B={B_L1} wall {1e3 * (t1 - t0):.3f} ms = first "
          f"explain pass {first:.3f} + l1 device pass, ey_adj copy and response set-up "
          f"{device_pass:.3f} + host selection and re-solve {host:.3f} ms", flush=True)
    return ey_err


def plan_constant_phase(explainer, X, bg, est, device, card):
    """Phase 12: the plan-constant path on the card (``use_kernel=False``):
    the cached arm equals the recomputing arm bit for bit, both stay within
    1e-5 of the classic function and within ``PHI_ATOL`` of the kernel
    route; it stays off for the default engine, which uses the kernel."""

    if explainer._explainer._plan_consts_enabled():
        raise AssertionError("the plan-constant path engaged beside fused_linear_ey")
    arms = {c: explain_headline(X[:1], bg, est, device, use_kernel=False,
                                plan_constant_cache=c)[0] for c in (None, False, "off")}
    for B in (1, 16, 256):
        phi = {c: np.stack(ks.explain(X[:B], silent=True).shap_values, 1)
               for c, ks in arms.items()}
        kern = np.stack(explainer.explain(X[:B], silent=True).shap_values, 1)
        bit = bool(np.array_equal(phi[None], phi[False]))
        d_off = max(float(np.abs(phi[c] - phi["off"]).max()) for c in (None, False))
        d_kern = float(np.abs(phi[None] - kern).max())
        print(f"plan constants B={B}: cached == recomputed bit for bit: {bit}; |phi - "
              f"phi 'off'|={d_off:.3e} (tol {OFF_ATOL:g}); |phi - phi kernel route|="
              f"{d_kern:.3e} (tol {PHI_ATOL:g}); kernel_path {arms[None].kernel_path}",
              flush=True)
        if not (bit and d_off <= OFF_ATOL and d_kern <= PHI_ATOL) \
                or arms[None].kernel_path != {"ey": "einsum_cached"}:
            raise AssertionError("the plan-constant path disagrees with its references")
    walls = {}
    for B in (1, 16):
        for name, ks in (("cached", arms[None]), ("uncached", arms[False]),
                         ("kernel", explainer)):
            walls[(name, B)] = median_wall_ms(lambda: ks.explain(X[:B], silent=True), 10)[0]
    print(f"times on {card}: explain wall median of 10 (ms), cached / uncached / kernel "
          f"route: " + "; ".join(
              f"B={B}: {walls[('cached', B)]:.3f} / {walls[('uncached', B)]:.3f} / "
              f"{walls[('kernel', B)]:.3f}" for B in (1, 16)), flush=True)


def importance_phase(explainer, expl, X):
    """Phase 13: ``rank_features`` on the headline rows reduces mean |phi|
    on the device through ``fused_linear_ey``; the mean matches the
    explain's."""

    import torch
    from distributedkernelshap_tpu_torch.ops.cuda_kernels import fused_linear_ey

    fused_linear_ey.launches = 0
    ranked = explainer.rank_features(X)
    torch.cuda.synchronize()
    launches, path = fused_linear_ey.launches, explainer.kernel_path
    imp = explainer._explainer.get_importance(X)
    phi = np.stack(expl.shap_values, 1)
    want = np.abs(phi).mean(0)
    tol = 1e-5 * max(1.0, float(np.abs(phi).max()))
    err = float(np.abs(imp - want).max())
    print(f"importance: rank_features B={len(X)}: launches fused_linear_ey={launches}, "
          f"kernel_path={path}; |mean|phi| device - explain|={err:.3e} (tol {tol:.2e}); "
          f"top groups {ranked['aggregated']['names'][:3]}", flush=True)
    if launches < 1 or path.get("ey") != "cuda" or not err <= tol:
        raise AssertionError("rank_features did not reduce through fused_linear_ey "
                             "or disagrees with the explain")


# ---------------------------------------------------------------------- #
# the non-linear sampled paths: tree masked_ey, MLPs, torch modules, black box


def kernel_launches():
    from distributedkernelshap_tpu_torch.ops import cuda_kernels

    return {name: getattr(cuda_kernels, name).launches
            for name in ("fused_linear_ey", "exact_tree_phi", "exact_tree_inter")}


def reset_launches():
    from distributedkernelshap_tpu_torch.ops import cuda_kernels

    for name in ("fused_linear_ey", "exact_tree_phi", "exact_tree_inter"):
        getattr(cuda_kernels, name).launches = 0


def explain_sampled(model, X, bg, device, link="logit", groups=True, **kw):
    """``KernelShap(model, link).fit(bg, ...).explain(X)`` with the Adult
    grouping (or ungrouped), the public API of every phase from 14 on."""

    from distributedkernelshap_tpu_torch import EngineConfig, KernelShap

    explainer = KernelShap(model, link=link, seed=0, device=device,
                           engine_config=kw.pop("engine_config", EngineConfig()))
    if groups:
        explainer.fit(bg, group_names=ADULT_GROUP_NAMES, groups=adult_groups())
    else:
        explainer.fit(bg)
    return explainer, explainer.explain(X, silent=True, **kw)


def sampled_phi(expl, B, K=2, M=None):
    phi = np.stack(expl.shap_values, 1)
    M = M or len(ADULT_WIDTHS)
    if phi.shape != (B, K, M) or not np.isfinite(phi).all():
        raise AssertionError(f"bad shap values: shape {phi.shape}, "
                             f"finite={np.isfinite(phi).all()}")
    err = additivity(expl)
    if not err < ADDITIVITY:
        raise AssertionError(f"additivity violated: {err}")
    return phi, err


def device_busy(fn):
    """``fn()`` once under ``torch.profiler``: ``(wall ms, device busy ms,
    idle share, device events, the four device kernels with the most time
    as (name, ms, count))``, busy being the union of the device events'
    intervals."""

    import torch
    from torch.profiler import DeviceType, ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy, end = 0.0, -np.inf
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in events):
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name = {}
    for e in events:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:4]
    return (wall_us / 1e3, busy / 1e3, 1.0 - busy / wall_us, len(events),
            [(name[:60], round(ms, 3), n) for name, (ms, n) in top])


def tree_step_split(explainer, X):
    """One explain with CUDA events around every ``masked_ey`` and every
    coalition chunk's tree loop (``TreeEnsemblePredictor._tree_steps``):
    ``(wall ms, masked_ey ms, tree steps ms, chunks)``; the chunk einsums
    (Q, R, C, hx, hb, the head and the background mean) are the masked_ey
    span less the tree steps."""

    import torch
    from distributedkernelshap_tpu_torch.models.trees import TreeEnsemblePredictor as T

    spans = {"steps": [], "masked": []}

    def timed(key, fn):
        def wrapper(*a, **k):
            start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = fn(*a, **k)
            stop.record()
            spans[key].append((start, stop))
            return out
        return wrapper

    steps, masked = T.__dict__["_tree_steps"], T.__dict__["masked_ey"]
    T._tree_steps = staticmethod(timed("steps", steps.__func__))
    T.masked_ey = timed("masked", masked)
    try:
        t0 = time.perf_counter()
        explainer.explain(X, silent=True)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    finally:
        T._tree_steps, T.masked_ey = steps, masked
    total = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in spans.items()}
    return wall, total["masked"], total["steps"], len(spans["steps"])


def sampled_tree_phase(tables, X_all, bg, device, card):
    """Phase 14: the sampled explain of the Adult-shaped GBT with the
    ``predict_proba`` head (``adult_trees``): ``masked_ey`` on the card,
    checked for additivity and against the CPU; ``masked_ey`` against the
    row evaluation; the exhaustive plan of the raw-margin tree against
    ``nsamples='exact'``; walls, device busy share and the tree-step split."""

    import torch
    from distributedkernelshap_tpu_torch.ops.explain import _auto_chunk, _ey_generic

    X = X_all[:B_TREES]
    reset_launches()
    explainer, expl = explain_sampled(tree_predictor(tables, device, "binary_sigmoid"),
                                      X, bg, device)
    torch.cuda.synchronize()
    path, launches = explainer.kernel_path, kernel_launches()
    engine = explainer._explainer
    plan = engine._plan(None)
    phi, add_err = sampled_phi(expl, B_TREES)
    _, expl_cpu = explain_sampled(tree_predictor(tables, "cpu", "binary_sigmoid"),
                                  X[:N_TREE_CPU], bg, "cpu")
    d_cpu = float(np.abs(phi[:N_TREE_CPU] - sampled_phi(expl_cpu, N_TREE_CPU)[0]).max())
    logits = expl.data["raw"]["raw_prediction"][:, 1]      # link space: the logit
    print(f"sampled tree: GBT T={N_TREES} depth {tables['depth']} head binary_sigmoid, "
          f"B={B_TREES} N={N_BACKGROUND} M={engine.M} S={plan.n_rows}: kernel_path={path}, "
          f"kernel launches {launches}; additivity={add_err:.3e} (< {ADDITIVITY:g}); "
          f"|phi card - phi cpu| (first {N_TREE_CPU} rows)={d_cpu:.3e} (tol {PHI_ATOL:g}); "
          f"max|phi|={np.abs(phi).max():.3f}; logit range [{logits.min():.2f}, "
          f"{logits.max():.2f}]", flush=True)
    if path != {"ey": "masked_ey"} or not d_cpu <= PHI_ATOL:
        raise AssertionError("the sampled tree explain disagrees with its references")
    if any(launches.values()):
        raise AssertionError(f"the sampled tree explain launched a hand kernel: {launches}")

    # masked_ey against the row evaluation of the same predictor, B = 16
    bg_t, bgw, mask, _, G = engine._device_args(plan)
    Xs = torch.as_tensor(X[:B_SMALL], device=device)
    bgw_n = bgw / bgw.sum()
    with torch.no_grad():
        ey = engine.predictor.masked_ey(Xs, bg_t, bgw_n, mask, G)
        rows = _ey_generic(engine.predictor, Xs, bg_t, bgw_n, mask @ G, _auto_chunk(
            plan.n_rows, B_SMALL * N_BACKGROUND * X.shape[1], 1 << 25))
    d_ey = float((ey - rows).abs().max())
    print(f"sampled tree: masked_ey vs row evaluation (_ey_generic) at B={B_SMALL}: "
          f"max|dey|={d_ey:.3e} (tol {EY_ATOL:g})", flush=True)
    if not (bool(ey.isfinite().all()) and d_ey <= EY_ATOL):
        raise AssertionError("masked_ey disagrees with the row evaluation")

    # every coalition of M = 12 enumerated: the sampled phi is the exact one
    margin = tree_predictor(tables, device)
    full, expl_full = explain_sampled(margin, X[:B_SMALL], bg, device, link="identity",
                                      nsamples=2 ** len(ADULT_WIDTHS) - 2)
    exhaustive = full._explainer._plan(2 ** len(ADULT_WIDTHS) - 2).exact
    phi_full = np.asarray(expl_full.shap_values[0])
    _, expl_exact = explain_exact(tables, X[:B_SMALL], bg, device)
    phi_exact = np.asarray(expl_exact.shap_values[0])
    d_exact = float(np.abs(phi_full - phi_exact).max())
    tol = EXACT_SAMPLED_REL * max(1.0, float(np.abs(phi_exact).max()))
    print(f"sampled tree: raw margin, nsamples={2 ** len(ADULT_WIDTHS) - 2} (plan "
          f"exhaustive: {exhaustive}) kernel_path={full.kernel_path} vs nsamples='exact' "
          f"at B={B_SMALL}: max|dphi|={d_exact:.3e} (tol {tol:.2e}), max|phi|="
          f"{np.abs(phi_exact).max():.3f}", flush=True)
    if not (exhaustive and full.kernel_path.get("ey") == "masked_ey" and d_exact <= tol):
        raise AssertionError("the exhaustive sampled tree explain disagrees with the exact one")

    wall, walls = median_wall_ms(lambda: explainer.explain(X, silent=True), 3)
    p_wall, busy, idle, events, top = device_busy(lambda: explainer.explain(X, silent=True))
    s_wall, masked_ms, steps_ms, chunks = tree_step_split(explainer, X)
    print(f"times on {card}: sampled tree explain B={B_TREES} wall median of 3 = "
          f"{wall:.3f} ms (runs {walls}); under torch.profiler: wall {p_wall:.3f} ms, "
          f"device busy {busy:.3f} ms, idle share {idle:.4f}, {events} device events, "
          f"most device time (name, ms, count): {top}; "
          f"CUDA-event split (wall {s_wall:.3f} ms): masked_ey {masked_ms:.3f} ms = tree "
          f"steps {steps_ms:.3f} ms ({chunks} coalition chunks x {N_TREES} trees) + chunk "
          f"einsums, head and background mean {masked_ms - steps_ms:.3f} ms; outside "
          f"masked_ey {s_wall - masked_ms:.3f} ms", flush=True)


def mlp_layers(seed):
    """``model_zoo``'s ``sklearn_mlp`` at the Adult width: 48 -> 32 ReLU -> 1
    logit, weights from ``seed`` scaled so the logits stay O(1)."""

    rng = np.random.default_rng([seed, 15])
    D = sum(ADULT_WIDTHS)
    return [(rng.normal(scale=0.4, size=(D, 32)).astype(np.float32),
             rng.normal(scale=0.1, size=32).astype(np.float32)),
            (rng.normal(scale=0.3, size=(32, 1)).astype(np.float32),
             np.array([-0.5], np.float32))]


def numpy_mlp(layers):
    """The same network as a numpy host callable (float32, ``[1-p, p]``)."""

    (W1, b1), (W2, b2) = layers

    def predict_proba(x):
        z = np.maximum(np.asarray(x, np.float32) @ W1 + b1, 0.0) @ W2 + b2
        p = 1.0 / (1.0 + np.exp(-z[:, 0]))
        return np.stack([1.0 - p, p], axis=1)

    return predict_proba


def torch_mlps(layers, device):
    """The same network as an ``nn.Sequential`` (the last layer widened to
    ``[0, z]`` under a softmax, which is ``[1-σ(z), σ(z)]``), which lifts, and
    as a module with a skip term, which does not."""

    import torch
    from torch import nn

    (W1, b1), (W2, b2) = layers
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    seq = nn.Sequential(nn.Linear(*W1.shape), nn.ReLU(), nn.Linear(W2.shape[0], 2),
                        nn.Softmax(dim=-1)).to(device)

    class SkipMLP(nn.Module):
        def __init__(self):
            super().__init__()
            self.hidden = nn.Linear(*W1.shape)
            self.out = nn.Linear(*W2.shape)
            self.skip = nn.Linear(W1.shape[0], 1, bias=False)   # a zero skip term

        def forward(self, x):
            z = self.out(torch.relu(self.hidden(x))) + self.skip(x)
            p = torch.sigmoid(z[:, 0])
            return torch.stack([1.0 - p, p], dim=1)

    skip = SkipMLP().to(device)
    with torch.no_grad():
        seq[0].weight.copy_(t(W1.T))
        seq[0].bias.copy_(t(b1))
        seq[2].weight.copy_(t(np.concatenate([np.zeros_like(W2), W2], 1).T))
        seq[2].bias.copy_(t(np.concatenate([np.zeros_like(b2), b2])))
        skip.hidden.weight.copy_(t(W1.T))
        skip.hidden.bias.copy_(t(b1))
        skip.out.weight.copy_(t(W2.T))
        skip.out.bias.copy_(t(b2))
        skip.skip.weight.zero_()
    return seq.eval(), skip.eval()


def mlp_phase(X_all, bg, device, card, seed):
    """Phase 15: ``model_zoo``'s ``sklearn_mlp`` as the scikit-learn lift
    lays it out (a ``TorchMLPPredictor`` over ``mlp_stages``, ``masked_ey``),
    the same weights as an ``nn.Sequential`` (lifted, ``masked_ey``) and as
    an unliftable module (``'generic'``).  Returns the first's phi at
    B = 256."""

    import torch
    from distributedkernelshap_tpu_torch import TorchMLPPredictor, TorchPredictor
    from distributedkernelshap_tpu_torch.models.torch_lift import mlp_stages

    X = X_all[:B_TREES]
    stages = mlp_stages(mlp_layers(seed), "relu", "binary_sigmoid")
    mlp = TorchMLPPredictor(stages, n_outputs=2, device=device)
    explainer, expl = explain_sampled(mlp, X, bg, device)
    phi, add_err = sampled_phi(expl, B_TREES)
    _, expl_cpu = explain_sampled(TorchMLPPredictor(stages, n_outputs=2, device="cpu"),
                                  X[:N_MLP_CPU], bg, "cpu")
    d_cpu = float(np.abs(phi[:N_MLP_CPU] - sampled_phi(expl_cpu, N_MLP_CPU)[0]).max())
    logits = expl.data["raw"]["raw_prediction"][:, 1]
    print(f"mlp: scikit-learn layout 48->32 relu->1 binary_sigmoid B={B_TREES}: kernel_path="
          f"{explainer.kernel_path}; additivity={add_err:.3e}; |phi card - phi cpu| (first "
          f"{N_MLP_CPU} rows)={d_cpu:.3e} (tol {PHI_ATOL:g}); logit range "
          f"[{logits.min():.2f}, {logits.max():.2f}]", flush=True)
    if explainer.kernel_path != {"ey": "masked_ey"} or not d_cpu <= PHI_ATOL:
        raise AssertionError("the MLP explain disagrees with its references")

    seq, skip = torch_mlps(mlp_layers(seed), device)
    routes = {"mlp": explainer}
    for name, model, cls, want in (("sequential", seq, TorchMLPPredictor, "masked_ey"),
                                   ("unliftable", skip, TorchPredictor, "generic")):
        ks, ex = explain_sampled(model, X, bg, device)
        got = sampled_phi(ex, B_TREES)[0]
        d = float(np.abs(got - phi).max())
        print(f"mlp: the same weights as {name} module -> {type(ks._explainer.predictor).__name__}"
              f", kernel_path={ks.kernel_path}; |phi - phi scikit-learn layout| at B={B_TREES}="
              f"{d:.3e} (tol {PHI_ATOL:g})", flush=True)
        if not (isinstance(ks._explainer.predictor, cls) and ks.kernel_path == {"ey": want}
                and d <= PHI_ATOL):
            raise AssertionError(f"the {name} module took the wrong route or disagrees")
        routes[name] = ks
    walls = {name: median_wall_ms(lambda: ks.explain(X, silent=True), 3)[0]
             for name, ks in routes.items()}
    walls_small = {name: median_wall_ms(lambda: ks.explain(X[:B_SMALL], silent=True), 3)[0]
                   for name, ks in routes.items()}
    torch.cuda.synchronize()
    print(f"times on {card}: MLP explain wall median of 3 (ms), scikit-learn layout masked_ey / "
          f"nn.Sequential lifted masked_ey / unliftable module generic: B={B_TREES}: "
          f"{walls['mlp']:.3f} / {walls['sequential']:.3f} / {walls['unliftable']:.3f}; "
          f"B={B_SMALL}: {walls_small['mlp']:.3f} / {walls_small['sequential']:.3f} / "
          f"{walls_small['unliftable']:.3f}", flush=True)
    return phi


def blackbox_phase(X_all, bg, device, card, seed, phi_mlp):
    """Phase 16: the numpy MLP as a ``CallbackPredictor`` (``adult_blackbox``):
    host evaluation (native fill) and the generic device route, both against
    phase 15's ``masked_ey`` answer; host-eval l1 on the ungrouped rows."""

    import os

    from distributedkernelshap_tpu_torch import CallbackPredictor, EngineConfig

    X = X_all[:B_SMALL]
    fn = numpy_mlp(mlp_layers(seed))
    runs = {}
    for name, host_eval, want in (("host-eval", True, {"ey": "host", "host_fill": "native"}),
                                  ("generic", False, {"ey": "generic"})):
        ks, expl = explain_sampled(CallbackPredictor(fn, example_dim=X.shape[1]), X, bg,
                                   device, engine_config=EngineConfig(host_eval=host_eval))
        phi = sampled_phi(expl, B_SMALL)[0]
        d = float(np.abs(phi - phi_mlp[:B_SMALL]).max())
        print(f"black box {name}: kernel_path={ks.kernel_path}; |phi - phi masked_ey| at "
              f"B={B_SMALL}={d:.3e} (tol {PHI_ATOL:g})", flush=True)
        if ks.kernel_path != want or not d <= PHI_ATOL:
            raise AssertionError(f"the black-box {name} explain took the wrong route or "
                                 f"disagrees")
        runs[name] = ks
    ks_l1, expl_l1 = explain_sampled(CallbackPredictor(fn, example_dim=X.shape[1]), X, bg,
                                     device, groups=False,
                                     engine_config=EngineConfig(host_eval=True))
    M = sum(ADULT_WIDTHS)
    _, add_l1 = sampled_phi(expl_l1, B_SMALL, M=M)
    sel = np.mean([len(t) for t in _selected(np.stack(expl_l1.shap_values, 1))])
    print(f"black box host-eval l1: ungrouped M={M} B={B_SMALL} l1_reg='auto': kernel_path="
          f"{ks_l1.kernel_path}; additivity={add_l1:.3e}; mean selected groups {sel:.2f} of "
          f"{M - 1}", flush=True)
    if ks_l1.kernel_path.get("ey") != "host":
        raise AssertionError("the host-eval l1 explain did not evaluate on the host")
    walls = {name: median_wall_ms(lambda: ks.explain(X, silent=True), 3)[0]
             for name, ks in runs.items()}
    l1_wall = median_wall_ms(lambda: ks_l1.explain(X, silent=True), 1)[0]
    print(f"times on {card}: black-box explain B={B_SMALL} wall median of 3 (ms): host-eval "
          f"{walls['host-eval']:.3f} (hosteval_workers={runs['host-eval'].hosteval_workers}, "
          f"os.cpu_count()={os.cpu_count()}), generic {walls['generic']:.3f}; host-eval l1 "
          f"M={M} {l1_wall:.3f}", flush=True)


# ---------------------------------------------------------------------- #
# the engine's serving entry points (phases 17-20)


def _exact_pair(expl, B, inter):
    """``(phi, interaction matrices or None)`` of an exact explanation,
    checked for shape, additivity and (with interactions) the convention."""

    phi, _ = exact_phi(expl, B)
    return phi, (interaction_values(expl, B)[0] if inter else None)


def chunked_phase(tables, X, bg, est, device, card, phi_headline):
    """Phase 17: ``EngineConfig(instance_chunk=256)`` on the headline rows
    (B = 2560: 10 chunks through ``run_pipeline``, one ``fused_linear_ey``
    launch each) and on the exact GBT with and without interactions, each
    counted and held against the unchunked answer; the resolved window, the
    round-trip probe, and the walls chunked and unchunked."""

    import torch
    from distributedkernelshap_tpu_torch.parallel import pipeline

    n_chunks = -(-B_HEADLINE // INSTANCE_CHUNK)
    rtt = pipeline.device_round_trip_s(device=device, refresh=True)
    reset_launches()
    explainer, expl = explain_headline(X, bg, est, device, instance_chunk=INSTANCE_CHUNK)
    torch.cuda.synchronize()
    launches = kernel_launches()
    window = explainer._explainer.last_dispatch_window
    phi, add_err = check_explanation(expl, B_HEADLINE)
    d_phi = float(np.abs(phi - phi_headline).max())
    print(f"chunked: B={B_HEADLINE} instance_chunk={INSTANCE_CHUNK} ({n_chunks} chunks), "
          f"window {window} (resolve_window: device round trip {1e3 * rtt:.4f} ms), "
          f"launches {launches}, kernel_path {explainer.kernel_path}; additivity "
          f"{add_err:.3e}, |phi chunked - phi unchunked|={d_phi:.3e} (tol {CHUNK_ATOL:g})",
          flush=True)
    if launches != {"fused_linear_ey": n_chunks, "exact_tree_phi": 0,
                    "exact_tree_inter": 0} or not d_phi <= CHUNK_ATOL:
        raise AssertionError("the chunked headline explain did not launch once per chunk "
                             "or disagrees with the unchunked one")
    whole = headline_explainer(bg, est, device)
    walls = {"sampled chunked": median_wall_ms(lambda: explainer.explain(X, silent=True), 3),
             "sampled unchunked": median_wall_ms(lambda: whole.explain(X, silent=True), 3)}
    for inter in (False, True):
        label = "interactions" if inter else "exact"
        reset_launches()
        ex_whole, want = explain_exact(tables, X, bg, device, interactions=inter)
        torch.cuda.synchronize()
        once = kernel_launches()
        reset_launches()
        ex_chunk, got = explain_exact(tables, X, bg, device, interactions=inter,
                                      instance_chunk=INSTANCE_CHUNK)
        torch.cuda.synchronize()
        chunked = kernel_launches()
        phi_w, inter_w = _exact_pair(want, B_HEADLINE, inter)
        phi_c, inter_c = _exact_pair(got, B_HEADLINE, inter)
        d = float(np.abs(phi_c - phi_w).max())
        tol = phi_tol(phi_w)
        d_inter = float(np.abs(inter_c - inter_w).max()) if inter else 0.0
        tol_inter = phi_tol(inter_w) if inter else 0.0
        per_chunk = {k: v * n_chunks for k, v in once.items()}
        print(f"chunked {label}: B={B_HEADLINE} in {n_chunks} chunks, window "
              f"{ex_chunk._explainer.last_dispatch_window}: launches {chunked} (unchunked "
              f"{once}), kernel_path {ex_chunk.kernel_path}; |phi chunked - unchunked|="
              f"{d:.3e} (tol {tol:.3e})" + (f", |interactions chunked - unchunked|="
                                           f"{d_inter:.3e} (tol {tol_inter:.3e})"
                                           if inter else ""), flush=True)
        if chunked != per_chunk or chunked["exact_tree_phi"] < n_chunks \
                or (inter and chunked["exact_tree_inter"] != n_chunks) \
                or not (d <= tol and d_inter <= tol_inter):
            raise AssertionError(f"the chunked {label} explain disagrees with the "
                                 "unchunked one or missed its kernels")
        kw = {"nsamples": "exact", "interactions": inter, "silent": True}
        walls[f"{label} chunked"] = median_wall_ms(lambda: ex_chunk.explain(X, **kw), 3)
        walls[f"{label} unchunked"] = median_wall_ms(lambda: ex_whole.explain(X, **kw), 3)
    print(f"times on {card}: B={B_HEADLINE} walls (one warm-up, median of 3, ms): "
          + "; ".join(f"{k} {v[0]:.3f} (runs {v[1]})" for k, v in walls.items()),
          flush=True)


def staging_phase(explainer, tables, X, bg, device, card):
    """Phase 18: ``stage_rows`` on a batcher thread, each batch staged while
    the one before is dispatched, ``get_explanation_async`` on this thread
    and ``finalize`` on a pool, as the serving pipeline runs them: every
    result bit-identical to ``get_explanation`` on the same rows, and one
    ``fused_linear_ey`` launch a batch; the same for one exact batch; the
    routes ``stage_rows`` declines; the staged loop's wall against the
    synchronous explains'."""

    from concurrent.futures import ThreadPoolExecutor

    import torch
    from distributedkernelshap_tpu_torch import EngineConfig, KernelShap
    from distributedkernelshap_tpu_torch.kernel_shap import StagedRows

    engine = explainer._explainer
    batches = [X[i * B_STAGED:(i + 1) * B_STAGED] for i in range(N_STAGED)]
    want, fx_want = [], []
    for b in batches:
        want.append(engine.get_explanation(b, silent=True))
        fx_want.append(engine.last_raw_prediction)

    def staged_loop():
        with ThreadPoolExecutor(1) as batcher, ThreadPoolExecutor(4) as finalizers:
            nxt = batcher.submit(engine.stage_rows, batches[0])
            futures = []
            for i in range(N_STAGED):
                staged = nxt.result()
                if not isinstance(staged, StagedRows) or (
                        staged.ready is None and torch.device(device).type == "cuda"):
                    raise AssertionError("stage_rows did not stage on the side stream")
                if i + 1 < N_STAGED:
                    nxt = batcher.submit(engine.stage_rows, batches[i + 1])
                futures.append(finalizers.submit(engine.get_explanation_async(staged)))
            return [f.result() for f in futures]

    reset_launches()
    results = staged_loop()
    torch.cuda.synchronize()
    launches = kernel_launches()
    same = all(all(np.array_equal(g, w) for g, w in zip(values, want[i]))
               and np.array_equal(info["raw_prediction"], fx_want[i])
               for i, (values, info) in enumerate(results))
    print(f"staging: {N_STAGED} batches of B={B_STAGED} headline rows staged on a batcher "
          f"thread (pinned host memory, side stream, event), dispatched here, finalized on "
          f"4 threads: launches {launches}, bit-identical to get_explanation: {same}",
          flush=True)
    if launches != {"fused_linear_ey": N_STAGED, "exact_tree_phi": 0,
                    "exact_tree_inter": 0} or not same:
        raise AssertionError("the staged async explains disagree with the synchronous "
                             "ones or missed the kernel")
    ex_exact, _ = explain_exact(tables, X[:B_EXACT], bg, device)
    eng_exact = ex_exact._explainer
    want_exact = eng_exact.get_explanation(X[:B_EXACT], nsamples="exact")
    staged = eng_exact.stage_rows(X[:B_EXACT], nsamples="exact")
    reset_launches()
    with ThreadPoolExecutor(1) as finalizer:
        values, info = finalizer.submit(
            eng_exact.get_explanation_async(staged, nsamples="exact")).result()
    torch.cuda.synchronize()
    exact_launches = kernel_launches()
    same_exact = all(np.array_equal(g, w) for g, w in zip(values, want_exact))
    print(f"staging exact: B={B_EXACT} staged, async: launches {exact_launches}, "
          f"bit-identical to get_explanation: {same_exact}", flush=True)
    if exact_launches["exact_tree_phi"] < 1 or not same_exact:
        raise AssertionError("the staged exact explain disagrees or missed its kernel")
    def engine_with(**cfg):
        return KernelShap(explainer.predictor, link="logit", seed=0, device=device,
                          engine_config=EngineConfig(**cfg)).fit(
            bg, group_names=ADULT_GROUP_NAMES, groups=adult_groups())._explainer

    declined = {
        "host eval": engine_with(host_eval=True).stage_rows(batches[0]),
        "active l1": engine.stage_rows(batches[0], l1_reg="num_features(4)"),
        "interactions": eng_exact.stage_rows(X[:B_EXACT], nsamples="exact",
                                             interactions=True),
        "over-chunk batch": engine_with(instance_chunk=8).stage_rows(batches[0]),
    }
    print("staging: stage_rows declines (returns None) for " + ", ".join(
        f"{k}: {v is None}" for k, v in declined.items()), flush=True)
    if any(v is not None for v in declined.values()):
        raise AssertionError("stage_rows staged a route the sync fallback serves")
    staged_ms = median_wall_ms(staged_loop, 3)
    sync_ms = median_wall_ms(lambda: [engine.get_explanation(b, silent=True)
                                      for b in batches], 3)
    print(f"times on {card}: {N_STAGED} batches of B={B_STAGED}: staged async loop "
          f"{staged_ms[0]:.3f} ms (runs {staged_ms[1]}), {N_STAGED} synchronous explains "
          f"{sync_ms[0]:.3f} ms (runs {sync_ms[1]})", flush=True)


def anytime_phase(explainer, X, bg, est, device, card, sm_count, sm_clock_hz):
    """Phase 19: ``anytime_begin(X).step()`` through all rounds on the
    headline task at B = 16 and 256, counted (5 ``fused_linear_ey`` launches
    a run), each round additive, the reported error monotone, the final
    round against the single-shot WLS over the concatenated rows, the
    ``use_kernel=False`` route and the port on the CPU; a run resumed on a
    fresh engine after round 1 bit for bit; at each round's ``(B, S)`` the
    kernel against its plain version on the inputs the round gave it;
    times.  Returns the kernel's largest difference from its plain version."""

    from dataclasses import replace

    import torch
    from distributedkernelshap_tpu_torch.anytime.engine import AnytimeRun
    from distributedkernelshap_tpu_torch.anytime.rounds import round_draw_mask
    from distributedkernelshap_tpu_torch.ops import explain as explain_mod
    from distributedkernelshap_tpu_torch.ops.cuda_kernels import (
        fused_linear_ey,
        fused_linear_ey_plain,
    )

    engine = explainer._explainer
    plain_engine = headline_explainer(bg, est, device, use_kernel=False)._explainer
    cpu_engine = headline_explainer(bg, est, "cpu")._explainer
    M, N, K = len(ADULT_WIDTHS), N_BACKGROUND, 2
    max_err = 0.0

    def run_all(eng, rows):
        run = eng.anytime_begin(rows)
        out = []
        while not run.done:
            out.append(run.step())
        return run, out

    for B in ANYTIME_BS:
        rows = X[:B]
        ey_calls = []

        def recorded_ey(*a, **k):
            ey_calls.append((a, k))
            return fused_linear_ey(*a, **k)

        reset_launches()
        explain_mod.fused_linear_ey = recorded_ey
        try:
            run = engine.anytime_begin(rows)
            results, round_ms = [], []
            while not run.done:
                t0 = time.perf_counter()
                results.append(run.step())
                round_ms.append(1e3 * (time.perf_counter() - t0))
            torch.cuda.synchronize()
        finally:
            explain_mod.fused_linear_ey = fused_linear_ey
        launches = kernel_launches()
        s = run.schedule
        shapes = [(tuple(a[0].shape), tuple(a[4].shape)) for a, _ in ey_calls]
        print(f"anytime B={B}: schedule enumerated S={s.n_enumerated}, draws {s.draws}, "
              f"weight_left {s.weight_left:.3f}; launches {launches}; kernel inputs "
              f"(XWg, mask) {shapes}; kernel_path {explainer.kernel_path}", flush=True)
        if launches != {"fused_linear_ey": ANYTIME_LAUNCHES, "exact_tree_phi": 0,
                        "exact_tree_inter": 0} or explainer.kernel_path.get("ey") != "cuda":
            raise AssertionError("the anytime run did not launch fused_linear_ey once per "
                                 "block")
        prev, adds = None, []
        for res in results:
            if res.phi.shape != (B, K, M) or not np.isfinite(res.phi).all():
                raise AssertionError(f"bad anytime phi: {res.phi.shape}")
            adds.append(float(np.abs(res.phi.sum(-1) - (res.raw_prediction
                                                         - res.expected_value[None])).max()))
            if prev is not None and not np.all(res.est_err <= prev):
                raise AssertionError("the anytime reported error went up")
            prev = res.est_err
        final = results[-1]
        # the single-shot WLS over the concatenated rows with count weights
        draws = np.concatenate([round_draw_mask(s, r) for r in range(s.n_rounds)], 0)
        mask = np.concatenate([s.enum_mask, draws], 0).astype(np.float32)
        weights = np.concatenate([s.enum_weights, np.full(
            draws.shape[0], s.weight_left / draws.shape[0], np.float32)]).astype(np.float32)
        fn = explain_mod.build_explainer_fn(
            engine.predictor, replace(engine.config.shap, link=engine.config.link))
        single = fn(*(torch.as_tensor(np.asarray(a, np.float32), device=device)
                      for a in (rows, engine.background, engine.bg_weights, mask,
                                weights, engine.G)))["shap_values"].cpu().numpy()
        d_single = float(np.abs(final.phi - single).max())
        _, plain_results = run_all(plain_engine, rows)
        d_plain = float(np.abs(final.phi - plain_results[-1].phi).max())
        n_cpu = min(B, N_CPU_ROWS)
        _, cpu_results = run_all(cpu_engine, rows[:n_cpu])
        d_cpu = float(np.abs(final.phi[:n_cpu] - cpu_results[-1].phi).max())
        # resume after round 1 on a fresh engine
        part = engine.anytime_begin(rows)
        part.step()
        part.step()
        fresh = headline_explainer(bg, est, device)._explainer
        resumed = AnytimeRun.restore(fresh, fresh._anytime_schedule(None), part.export_state())
        resumed_results = []
        while not resumed.done:
            resumed_results.append(resumed.step())
        bit = all(np.array_equal(a.phi, b.phi) and np.array_equal(a.raw_gap, b.raw_gap)
                  for a, b in zip(results[2:], resumed_results))
        print(f"anytime B={B}: additivity per round {[f'{a:.2e}' for a in adds]} (< "
              f"{ADDITIVITY:g}); est_err max per round "
              f"{[round(r.max_err, 6) for r in results]} (monotone); final vs single-shot "
              f"WLS {d_single:.3e} (tol {ANYTIME_SINGLE_SHOT:g}), vs use_kernel=False "
              f"{d_plain:.3e} (tol {PHI_ATOL:g}), vs the CPU (first {n_cpu} rows) "
              f"{d_cpu:.3e} (tol {PHI_ATOL:g}); resumed after round 1 on a fresh engine, "
              f"rounds 2-3 bit-identical: {bit}", flush=True)
        if not (max(adds) < ADDITIVITY and d_single <= ANYTIME_SINGLE_SHOT
                and d_plain <= PHI_ATOL and d_cpu <= PHI_ATOL and bit):
            raise AssertionError("the anytime run disagrees with its references")
        # the kernel at each round's (B, S), on the round's own inputs, timed
        parts = []
        for (a, k) in ey_calls:
            got, ref = fused_linear_ey(*a, **k), fused_linear_ey_plain(*a, **k)
            err = float((got - ref).abs().max())
            max_err = max(max_err, err)
            if not (bool(got.isfinite().all()) and err <= EY_ATOL):
                raise AssertionError(f"fused_linear_ey disagrees with its plain version at "
                                     f"anytime shape {tuple(a[4].shape)}: {err}")
            S = a[4].shape[0]
            k_ms = cuda_time_ms(lambda: fused_linear_ey(*a, **k), 50)
            # the wrapper's host time a call (checks, normalising bgw, the
            # output's allocation, the ctypes launch), issued without a sync:
            # where it reaches the CUDA-event time, the card waits on the host
            t0 = time.perf_counter()
            for _ in range(50):
                fused_linear_ey(*a, **k)
            issue_ms = 1e3 * (time.perf_counter() - t0) / 50
            torch.cuda.synchronize()
            b_ms, b_by = ey_bound_ms(a[0].shape[0], S, N, M, K, "softmax", sm_count,
                                     sm_clock_hz)
            parts.append(f"S={S}: kernel {k_ms:.4f} ms (host issue {issue_ms:.4f} ms a "
                         f"call), bound {b_ms:.4f} ms ({b_by}), |ey - plain| {err:.2e}")
        run_ms = median_wall_ms(lambda: run_all(engine, rows), 3)
        classic_ms = median_wall_ms(lambda: explainer.explain(rows, silent=True), 3)
        print(f"times on {card}: anytime B={B}: walls per round (ms) "
              f"{[round(r, 3) for r in round_ms]}; fused_linear_ey per block at B={B}: "
              + "; ".join(parts) + f"; whole run {run_ms[0]:.3f} ms (runs {run_ms[1]}) "
              f"against the classic explain {classic_ms[0]:.3f} ms (runs {classic_ms[1]})",
              flush=True)
    return max_err


def profiler_checkpoint_phase(explainer, expl, tables, X, bg, device, card):
    """Phase 20: with the profiler on, one headline explain yields its
    phases and ``trace()`` writes a Chrome trace; ``save`` then ``load`` of
    the headline explainer and of the exact explainer with interactions,
    each explaining bit-identically to the writer."""

    import os
    import tempfile

    import torch
    from distributedkernelshap_tpu_torch import KernelShap
    from distributedkernelshap_tpu_torch.profiling import profiler

    prof = profiler()
    prof.enable()
    prof.reset()
    try:
        explainer.explain(X, silent=True)
        summary = prof.summary()
        with tempfile.TemporaryDirectory() as tmp:
            with prof.trace(os.path.join(tmp, "trace")):
                explainer.explain(X[:B_STAGED], silent=True)
                torch.cuda.synchronize()
            trace_bytes = os.path.getsize(prof.last_trace_path)
    finally:
        prof.disable()
        prof.reset()
    print(f"profiler: phases {sorted(summary)}; explain {1e3 * summary['explain']['total_s']:.3f}"
          f" ms, device_explain {1e3 * summary['device_explain']['total_s']:.3f} ms; trace() "
          f"wrote a Chrome trace of {trace_bytes} bytes", flush=True)
    if not ({"explain", "coalition_plan", "device_explain"} <= set(summary)
            and trace_bytes > 0):
        raise AssertionError("the profiler missed the explain's phases or wrote no trace")
    ex_inter, before_inter = explain_exact(tables, X[:B_EXACT], bg, device, interactions=True)
    with tempfile.TemporaryDirectory() as tmp:
        explainer.save(os.path.join(tmp, "headline.pkl"))
        ex_inter.save(os.path.join(tmp, "exact.pkl"))
        loaded = KernelShap.load(os.path.join(tmp, "headline.pkl"))
        loaded_inter = KernelShap.load(os.path.join(tmp, "exact.pkl"))
    after = loaded.explain(X, silent=True)
    same = all(np.array_equal(a, b) for a, b in zip(after.shap_values, expl.shap_values))
    after_inter = loaded_inter.explain(X[:B_EXACT], nsamples="exact", silent=True,
                                       interactions=True)
    same_inter = (np.array_equal(after_inter.shap_values[0], before_inter.shap_values[0])
                  and np.array_equal(after_inter.data["raw"]["interaction_values"][0],
                                     before_inter.data["raw"]["interaction_values"][0]))
    print(f"checkpoint: the headline explainer saved and loaded (device {loaded.device}, "
          f"kernel_path {loaded.kernel_path}): bit-identical {same}; the exact explainer "
          f"with interactions (kernel_path {loaded_inter.kernel_path}): bit-identical "
          f"{same_inter}", flush=True)
    if not (same and same_inter and loaded.kernel_path.get("ey") == "cuda"):
        raise AssertionError("a loaded explainer disagrees with its writer")


# ---------------------------------------------------------------------- #
# the seventh slice (phases 22-28): booster dumps, an affine head, an
# IsolationForest-shaped ensemble, tensor trains, the singular Gram, the
# headline's WLS host time and the Adult parity fixture


def xgboost_json(tables, objective="reg:squarederror", base_score=GBT_BASE):
    """The seeded ensemble as an xgboost ``save_raw('json')`` model (the
    documented schema ``models/xgb.py`` parses): one tree per seeded tree,
    its used nodes in the seeded numbering (children allocated two at a
    time, as xgboost's loss-guided grower numbers them), leaves with -1
    children and their value in ``split_conditions``.  xgboost routes left
    on ``x < t``, so a split condition is the next float32 above the seeded
    threshold (``f32_lt_threshold`` maps it back); NaN goes right, as the
    seeded tables send it."""

    trees = []
    for t in range(tables["feature"].shape[0]):
        left, right = tables["left"][t], tables["right"][t]
        n = 1 + max(int(left.max()), int(right.max()))
        leaf = left[:n] == np.arange(n)
        thr_up = np.nextafter(tables["threshold"][t, :n], np.float32(np.inf))
        trees.append({
            "split_indices": [0 if leaf[j] else int(tables["feature"][t, j]) for j in range(n)],
            "split_conditions": [float(tables["value"][t, j, 0]) if leaf[j]
                                 else float(thr_up[j]) for j in range(n)],
            "left_children": [-1 if leaf[j] else int(left[j]) for j in range(n)],
            "right_children": [-1 if leaf[j] else int(right[j]) for j in range(n)],
            "default_left": [0] * n, "split_type": [0] * n, "categories": []})
    return {"learner": {
        "objective": {"name": objective},
        "learner_model_param": {"base_score": repr(float(base_score)), "num_class": "0"},
        "gradient_booster": {"model": {"trees": trees, "tree_info": [0] * len(trees)}}}}


def lightgbm_dump(tables, objective="regression"):
    """The seeded ensemble as a LightGBM ``dump_model()`` dict (nested
    nodes, ``x <= t`` left, the float32 thresholds as doubles).  LightGBM
    stores no separate bias, so this is the ensemble with base 0."""

    def node(t, j):
        if tables["left"][t, j] == j:
            return {"leaf_value": float(tables["value"][t, j, 0])}
        return {"split_feature": int(tables["feature"][t, j]),
                "threshold": float(tables["threshold"][t, j]), "decision_type": "<=",
                "default_left": False, "left_child": node(t, int(tables["left"][t, j])),
                "right_child": node(t, int(tables["right"][t, j]))}

    return {"objective": objective, "num_class": 1, "average_output": False,
            "tree_info": [{"tree_structure": node(t, 0)}
                          for t in range(tables["feature"].shape[0])]}


def booster_owner(cls_name, dump, reference):
    """A stand-in for a fitted xgboost or LightGBM scikit-learn estimator
    (neither package is on the card's machine): an instance of a class named
    ``cls_name`` whose ``get_booster().save_raw('json')`` (``XGB*``) or
    ``booster_.dump_model()`` (``LGBM*``) returns ``dump``, and whose
    ``predict`` / ``predict_proba`` is the numpy callable ``reference``, which
    the lift's probe holds the lifted ensemble against."""

    class Booster:
        def save_raw(self, raw_format="json"):
            return bytearray(json.dumps(dump).encode())

        def dump_model(self):
            return dump

    def predict(self, X):
        return reference(X)

    def predict_proba(self, X):
        return reference(X)

    return type(cls_name, (), {"predict": predict, "predict_proba": predict_proba,
                               "get_booster": lambda self: Booster(),
                               "booster_": Booster()})()


def numpy_fn(pred, device, scalar=False):
    """``pred`` as a numpy callable (rows in, outputs out; one column as a
    vector when ``scalar``)."""

    import torch

    def fn(X):
        with torch.no_grad():
            out = pred(torch.as_tensor(np.asarray(X, np.float32), device=device))
        out = out.cpu().numpy()
        return out[:, 0] if scalar else out

    return fn


def fit_exact(model, bg, device, instance_chunk=None):
    """``KernelShap(model)`` fitted on ``bg`` with the Adult grouping, for
    the exact path (identity link)."""

    from distributedkernelshap_tpu_torch import EngineConfig, KernelShap

    explainer = KernelShap(model, task="regression", seed=0, device=device,
                           engine_config=EngineConfig(instance_chunk=instance_chunk))
    return explainer.fit(bg, group_names=ADULT_GROUP_NAMES, groups=adult_groups())


def rel_close(got, ref, rel=PHI_REL) -> float:
    """``max|got - ref|`` after checking it is within ``rel · max(1,
    max|ref|)``; raises otherwise."""

    got, ref = np.asarray(got), np.asarray(ref)
    err = float(np.abs(got - ref).max())
    if got.shape != ref.shape or not np.isfinite(got).all() \
            or not err <= rel * max(1.0, float(np.abs(ref).max())):
        raise AssertionError(f"shape {got.shape} vs {ref.shape}, max abs diff {err:.3e} "
                             f"above {rel:g} x max(1, max|ref|)")
    return err


def boosters_phase(tables, X_all, bg, device, card):
    """Phase 22: the seeded GBT as xgboost and LightGBM dumps, lifted through
    the public entry point (``KernelShap(owner.predict)`` → ``as_predictor``
    → ``lift_xgboost`` / ``lift_lightgbm``, probe included): the lifted
    predictions equal the seeded ensemble's bit for bit (regression) or
    within 1e-6 (sigmoid heads); the regression lifts' exact explains and
    the xgboost lift's interaction explain, counted, against the seeded
    ensemble's within ``PHI_REL``; each kernel against its plain version
    on these paths' inputs; the binary lifts' sampled explains at
    ``B_BOOSTER`` through ``masked_ey`` (no hand kernel).  Returns the
    worst kernel-vs-plain differences ``(phi, inter)``."""

    import torch
    from distributedkernelshap_tpu_torch.models.trees import TreeEnsemblePredictor
    from distributedkernelshap_tpu_torch.ops.cuda_kernels import (
        exact_tree_inter,
        exact_tree_inter_plain,
        exact_tree_phi,
        exact_tree_phi_plain,
    )
    from distributedkernelshap_tpu_torch.ops.explain import groups_to_matrix
    from distributedkernelshap_tpu_torch.ops.treeshap import (
        build_packed_plan,
        resolve_pack_paths,
    )

    X = X_all[:B_EXACT]
    seeded_t, ref = fit_exact(tree_predictor(tables, device), bg, device), {}
    ref["phi"] = np.asarray(seeded_t.explain(X, nsamples="exact", silent=True).shap_values[0])
    ref["inter"] = seeded_t.explain(X, nsamples="exact", interactions=True, silent=True
                                    ).data["raw"]["interaction_values"][0]
    plan = build_packed_plan(tree_predictor(tables, "cpu"),
                             groups_to_matrix(adult_groups(), X.shape[1]))
    packs = resolve_pack_paths(None, plan)
    n_buckets = len(plan.buckets) if packs else 1
    worst_phi = worst_inter = 0.0
    for name, cls, dump, base in (
            ("xgboost reg:squarederror", "XGBRegressor", xgboost_json(tables), GBT_BASE),
            ("LightGBM regression", "LGBMRegressor", lightgbm_dump(tables), 0.0)):
        seeded = tree_predictor(tables, device, base=base)
        owner = booster_owner(cls, dump, numpy_fn(seeded, device, scalar=True))
        explainer = fit_exact(owner.predict, bg, device)
        lifted = explainer._explainer.predictor
        if not isinstance(lifted, TreeEnsemblePredictor):
            raise AssertionError(f"the {name} dump did not lift: {type(lifted).__name__}")
        with torch.no_grad():
            Xt = torch.as_tensor(X_all, device=device)
            same = bool(torch.equal(lifted(Xt), seeded(Xt)))
        reset_launches()
        expl = explainer.explain(X, nsamples="exact", silent=True)
        torch.cuda.synchronize()
        launches = kernel_launches()
        phi, add_err = exact_phi(expl, B_EXACT)
        d_ref = rel_close(phi, ref["phi"])
        wall, runs = median_wall_ms(lambda: explainer.explain(X, nsamples="exact",
                                                              silent=True), 3)
        print(f"booster {name}: lifted to {type(lifted).__name__} (T={lifted.n_trees}, "
              f"nodes {lifted.feature.shape[1]}), predictions on {X_all.shape[0]} rows "
              f"bit-identical to the seeded ensemble (base {base}): {same}; exact explain "
              f"B={B_EXACT}: launches {launches} (want exact_tree_phi={n_buckets}), "
              f"kernel_path {explainer.kernel_path}, additivity {add_err:.3e}, |phi - seeded "
              f"phi|={d_ref:.3e}; wall median of 3 {wall:.3f} ms (runs {runs}) on {card}",
              flush=True)
        if not same or launches["exact_tree_phi"] != n_buckets \
                or explainer.kernel_path != {"exact_phi": "cuda"}:
            raise AssertionError(f"the {name} lift is not the seeded ensemble on the "
                                 "exact kernel path")
        for args, dmax in (bucket_inputs(explainer, X, device) if packs
                           else [dense_inputs(explainer, X, device)]):
            got, plain = exact_tree_phi(*args, dmax=dmax), exact_tree_phi_plain(*args, dmax=dmax)
            worst_phi = max(worst_phi, rel_close(got.cpu().numpy(), plain.cpu().numpy()))
        if cls == "XGBRegressor":
            reset_launches()
            expl_i = explainer.explain(X, nsamples="exact", interactions=True, silent=True)
            torch.cuda.synchronize()
            launches = kernel_launches()
            inter = expl_i.data["raw"]["interaction_values"][0]
            d_inter = rel_close(inter, ref["inter"])
            args, dmax = dense_inputs(explainer, X, device)
            got, plain = (exact_tree_inter(*args, dmax=dmax),
                          exact_tree_inter_plain(*args, dmax=dmax))
            err, ok = raw_close(got, plain)
            if not ok:
                raise AssertionError("exact_tree_inter disagrees with its plain version on "
                                     "the lifted booster's inputs")
            worst_inter = max(worst_inter, err)
            print(f"booster {name}: interaction explain launches {launches} (want 1 + 1), "
                  f"|inter - seeded inter|={d_inter:.3e}, exact_tree_inter vs plain on its "
                  f"inputs {worst_inter:.3e}", flush=True)
            if launches["exact_tree_inter"] != 1 or launches["exact_tree_phi"] != 1:
                raise AssertionError("the lifted booster's interactions missed the kernels")
    for name, cls, dump in (
            ("xgboost binary:logistic", "XGBClassifier",
             xgboost_json(tables, "binary:logistic", 1.0 / (1.0 + np.exp(-GBT_BASE)))),
            ("LightGBM binary", "LGBMClassifier", lightgbm_dump(tables, "binary"))):
        base = GBT_BASE if cls == "XGBClassifier" else 0.0
        seeded = tree_predictor(tables, device, head="binary_sigmoid", base=base)
        owner = booster_owner(cls, dump, numpy_fn(seeded, device))
        reset_launches()
        explainer, expl = explain_sampled(owner.predict_proba, X[:B_BOOSTER], bg, device)
        torch.cuda.synchronize()
        launches = kernel_launches()
        lifted = explainer._explainer.predictor
        with torch.no_grad():
            Xt = torch.as_tensor(X_all, device=device)
            d_pred = float((lifted(Xt) - seeded(Xt)).abs().max())
        phi, add_err = sampled_phi(expl, B_BOOSTER)
        _, expl_seed = explain_sampled(seeded, X[:B_BOOSTER], bg, device)
        d_seed = float(np.abs(phi - sampled_phi(expl_seed, B_BOOSTER)[0]).max())
        wall, _ = median_wall_ms(lambda: explainer.explain(X[:B_BOOSTER], silent=True), 1)
        print(f"booster {name}: lifted to {type(lifted).__name__}, |p lifted - p seeded|="
              f"{d_pred:.3e} (tol 1e-6); sampled explain B={B_BOOSTER}: launches {launches} "
              f"(want all 0), kernel_path {explainer.kernel_path}, additivity {add_err:.3e}, "
              f"|phi - seeded phi|={d_seed:.3e} (tol {PHI_ATOL:g}); wall {wall:.3f} ms on "
              f"{card}", flush=True)
        if not (isinstance(lifted, TreeEnsemblePredictor) and d_pred <= 1e-6
                and not any(launches.values()) and d_seed <= PHI_ATOL
                and explainer.kernel_path.get("ey") == "masked_ey"):
            raise AssertionError(f"the {name} lift's sampled explain is off")
    print(f"boosters: kernel vs plain on the lifted paths' inputs: exact_tree_phi "
          f"{worst_phi:.3e}, exact_tree_inter {worst_inter:.3e}", flush=True)
    return worst_phi, worst_inter


def affine_phase(tables, X_all, bg, device, card):
    """Phase 23: ``AffineOutputPredictor(gbt, AFFINE_A, AFFINE_B)`` on the
    exact path, counted: phi is ``AFFINE_A`` × the bare tree's, E and f(x)
    carry the head, against the CPU port on the first rows."""

    import torch
    from distributedkernelshap_tpu_torch import AffineOutputPredictor

    X = X_all[:B_EXACT]
    bare = fit_exact(tree_predictor(tables, device), bg, device)
    expl_bare = bare.explain(X, nsamples="exact", silent=True)
    head = fit_exact(AffineOutputPredictor(tree_predictor(tables, device), AFFINE_A, AFFINE_B),
                     bg, device)
    reset_launches()
    expl = head.explain(X, nsamples="exact", silent=True)
    torch.cuda.synchronize()
    launches = kernel_launches()
    phi, add_err = exact_phi(expl, B_EXACT)
    d_phi = rel_close(phi, AFFINE_A * np.asarray(expl_bare.shap_values[0]))
    e_bare = float(np.ravel(expl_bare.expected_value)[0])
    d_e = abs(float(np.ravel(expl.expected_value)[0]) - (AFFINE_A * e_bare + AFFINE_B))
    d_fx = float(np.abs(expl.data["raw"]["raw_prediction"]
                        - (AFFINE_A * expl_bare.data["raw"]["raw_prediction"] + AFFINE_B)).max())
    cpu = fit_exact(AffineOutputPredictor(tree_predictor(tables, "cpu"), AFFINE_A, AFFINE_B),
                    bg, "cpu")
    d_cpu = rel_close(phi[:N_CPU_ROWS], np.asarray(cpu.explain(
        X[:N_CPU_ROWS], nsamples="exact", silent=True).shap_values[0]))
    wall, _ = median_wall_ms(lambda: head.explain(X, nsamples="exact", silent=True), 3)
    print(f"affine head a={AFFINE_A} b={AFFINE_B}: launches {launches}, kernel_path "
          f"{head.kernel_path}, additivity {add_err:.3e}, |phi - a phi bare|={d_phi:.3e}, "
          f"|E - (a E bare + b)|={d_e:.3e}, |f(x) - (a f bare + b)|={d_fx:.3e}, |phi card - "
          f"phi cpu| (first {N_CPU_ROWS} rows)={d_cpu:.3e}; wall B={B_EXACT} {wall:.3f} ms "
          f"on {card}", flush=True)
    tol = 1e-5 * max(1.0, abs(AFFINE_A * e_bare))
    if launches["exact_tree_phi"] < 1 or head.kernel_path != {"exact_phi": "cuda"} \
            or not (d_e <= tol and d_fx <= 1e-5 * max(1.0, float(np.abs(
                expl.data["raw"]["raw_prediction"]).max()))):
        raise AssertionError("the affine head's exact explain is off")


def iforest_tables(seed):
    """Node tables of an IsolationForest-shaped ensemble made from ``seed``:
    ``N_IFOREST_TREES`` isolation trees, each grown on ``IFOREST_SAMPLES``
    Adult-shaped rows by a random column and a threshold uniform in the
    node's range, to one row or depth ``ceil(log2(IFOREST_SAMPLES))``; a
    leaf pays its depth plus c(rows at the leaf), as scikit-learn's
    ``score_samples`` counts it (``models/trees._iforest_tree_table``)."""

    from distributedkernelshap_tpu_torch.models.trees import _average_path_length

    rng = np.random.default_rng([seed, 23])
    n_nodes = 2 * IFOREST_SAMPLES - 1
    limit = int(np.ceil(np.log2(IFOREST_SAMPLES)))
    T = N_IFOREST_TREES
    feature = np.zeros((T, n_nodes), np.int64)
    threshold = np.full((T, n_nodes), np.inf, np.float32)
    left = np.tile(np.arange(n_nodes), (T, 1))
    right = left.copy()
    value = np.zeros((T, n_nodes, 1), np.float32)
    depth = 0
    for t in range(T):
        sample = adult_shaped_rows(rng, IFOREST_SAMPLES)
        stack, n_used = [(0, np.arange(IFOREST_SAMPLES), 0)], 1
        while stack:
            j, rows, d = stack.pop()
            sub = sample[rows]
            cols = [c for c in range(sub.shape[1]) if np.ptp(sub[:, c]) > 0]
            if d >= limit or rows.size <= 1 or not cols:
                value[t, j, 0] = d + _average_path_length([rows.size])[0]
                depth = max(depth, d)
                continue
            c = int(rng.choice(cols))
            lo, hi = sub[:, c].min(), sub[:, c].max()
            thr = np.float32(rng.uniform(lo, hi))
            thr = min(max(thr, lo), np.nextafter(hi, np.float32(-np.inf)))
            go_left = sub[:, c] <= thr
            lc, rc = n_used, n_used + 1
            n_used += 2
            feature[t, j], threshold[t, j], left[t, j], right[t, j] = c, thr, lc, rc
            stack += [(lc, rows[go_left], d + 1), (rc, rows[~go_left], d + 1)]
    c_norm = float(_average_path_length([IFOREST_SAMPLES])[0])
    return dict(feature=feature, threshold=threshold, left=left, right=right,
                value=value, depth=depth, scale=-1.0 / c_norm)


def iforest_phase(X_all, bg, device, card, seed):
    """Phase 24: the IsolationForest-shaped ensemble (``neg_exp2`` head, the
    ``score_samples`` lift's layout) explained by sampling at ``B_IFOREST``
    with ``link='identity'``: ``masked_ey``, no hand kernel, additive,
    against the CPU port; its ``decision_function`` form (an affine head of
    offset -0.5) gives the same phi, E shifted."""

    import torch
    from distributedkernelshap_tpu_torch import AffineOutputPredictor, TreeEnsemblePredictor

    t = iforest_tables(seed)

    def forest(dev):
        return TreeEnsemblePredictor(
            t["feature"], t["threshold"], t["left"], t["right"], t["value"],
            depth=t["depth"], aggregation="mean", scale=t["scale"],
            out_transform="neg_exp2", vector_out=False, device=dev)

    X = X_all[:B_IFOREST]
    reset_launches()
    explainer, expl = explain_sampled(forest(device), X, bg, device, link="identity")
    torch.cuda.synchronize()
    launches = kernel_launches()
    phi, add_err = sampled_phi(expl, B_IFOREST, K=1)
    _, expl_cpu = explain_sampled(forest("cpu"), X[:N_TREE_CPU], bg, "cpu", link="identity")
    d_cpu = float(np.abs(phi[:N_TREE_CPU] - sampled_phi(expl_cpu, N_TREE_CPU, K=1)[0]).max())
    _, expl_df = explain_sampled(AffineOutputPredictor(forest(device), 1.0, 0.5), X, bg,
                                 device, link="identity")
    d_df = float(np.abs(phi - sampled_phi(expl_df, B_IFOREST, K=1)[0]).max())
    d_e = abs(float(np.ravel(expl_df.expected_value)[0])
              - float(np.ravel(expl.expected_value)[0]) - 0.5)
    wall, runs = median_wall_ms(lambda: explainer.explain(X, silent=True), 3)
    pred = explainer._explainer.predictor
    print(f"isolation forest: T={N_IFOREST_TREES} trees on {IFOREST_SAMPLES} samples, "
          f"depth {t['depth']}, leaves {pred.n_leaves}; sampled B={B_IFOREST}: launches "
          f"{launches} (want all 0), kernel_path {explainer.kernel_path}, additivity "
          f"{add_err:.3e}, |phi card - phi cpu| (first {N_TREE_CPU} rows)={d_cpu:.3e}, "
          f"decision_function form |phi - phi|={d_df:.3e} |E shift - 0.5|={d_e:.3e}; wall "
          f"median of 3 {wall:.3f} ms (runs {runs}) on {card}", flush=True)
    if any(launches.values()) or explainer.kernel_path.get("ey") != "masked_ey" \
            or not (d_cpu <= 1e-4 and d_df <= 1e-5 and d_e <= 1e-5):
        raise AssertionError("the IsolationForest-shaped explain is off")


def tt_cores(M, rank, seed, K=1, b_scale=0.3):
    """Random tensor-train cores with per-site scale ``rank^-1/2`` (the
    chained products stay O(1) over M sites), as the reference's tests
    make them."""

    rng = np.random.default_rng([seed, M, rank])
    dims = [1] + [rank] * (M - 1) + [K]
    scale = 1.0 / np.sqrt(rank)
    return [(rng.normal(scale=scale, size=(dims[i], dims[i + 1])).astype(np.float32),
             rng.normal(scale=b_scale * scale, size=(dims[i], dims[i + 1])).astype(np.float32))
            for i in range(M)]


def tt_brute_force(cores, X, bg):
    """float64 Shapley values ``(B, K, M)`` of the TT model by enumerating
    all 2^M coalitions through the host cores (the reference's oracle)."""

    from math import factorial

    M = len(cores)
    masks = ((np.arange(2 ** M)[:, None] >> np.arange(M)[None]) & 1).astype(bool)
    size = masks.sum(1)
    K = cores[-1][0].shape[1]
    phi = np.zeros((X.shape[0], K, M))
    for bi, x in enumerate(np.asarray(X, np.float64)):
        rows = np.where(masks[:, None, :], x[None, None], np.asarray(bg, np.float64)[None])
        v = np.ones(rows.shape[:2] + (1,))
        for i, (A, Bc) in enumerate(cores):
            v = np.einsum("cnr,cnrs->cns", v, A[None, None].astype(np.float64)
                          + rows[:, :, i, None, None] * Bc[None, None].astype(np.float64))
        value = v.mean(1)                                         # (2^M, K)
        for j in range(M):
            without = np.flatnonzero(~masks[:, j])
            w = np.array([factorial(k) * factorial(M - 1 - k) / factorial(M)
                          for k in size[without]])
            phi[bi, :, j] = w @ (value[without | (1 << j)] - value[without])
    return phi


def tn_dp_flops(M, rank, K):
    """f32 operations of the port's DP per (instance, background row): per
    site the prefix products ``L·P``, ``L·Q`` (2·M·r² each), the size-weight
    fold (2·M²·r), the suffix products ``P·T``, ``Q·T`` (2·M·r²·K each) and
    the contraction (2·M·r·K)."""

    return M * (4 * M * rank * rank + 2 * M * M * rank + 4 * M * rank * rank * K
                + 2 * M * rank * K)


def tn_phase(device, card, seed):
    """Phase 25: exact tensor-train SHAP (``nsamples='exact'`` on a
    ``TensorTrainPredictor``).  The reference's mid-size TN at B = 8 and
    256 against the CPU port, a staged explain bit-identical to the
    synchronous one; a TN at M = 12 against brute-force enumeration; the
    Adult-width TN (M = 48, rank 16, N = 100, B = 256): wall, device events
    and busy time, and the share of its FLOP bound.  The path runs no hand
    kernel (its launch counts must stay 0)."""

    import torch
    from distributedkernelshap_tpu_torch import EngineConfig, KernelShap, TensorTrainPredictor
    from distributedkernelshap_tpu_torch.kernel_shap import StagedRows

    def fit(cores, bg, dev):
        explainer = KernelShap(TensorTrainPredictor(cores, device=dev), seed=0, device=dev,
                               task="regression", engine_config=EngineConfig())
        return explainer.fit(bg)

    def phi_of(expl, B, M):
        phi = np.stack(expl.shap_values, 1)
        if phi.shape != (B, 1, M) or not np.isfinite(phi).all():
            raise AssertionError(f"bad TN shap values: shape {phi.shape}")
        err = additivity(expl)
        if not err < ADDITIVITY:
            raise AssertionError(f"TN additivity violated: {err}")
        return phi, err

    rng = np.random.default_rng([seed, 25])
    out = {}
    for label, (M, rank, N), Bs in (("mid", TN_MID, TN_MID_BS), ("adult", TN_ADULT, (B_TN,))):
        cores = tt_cores(M, rank, seed)
        bg = rng.normal(size=(N, M)).astype(np.float32)
        X = rng.normal(size=(max(Bs), M)).astype(np.float32)
        explainer = fit(cores, bg, device)
        cpu = fit(cores, bg, "cpu")
        for B in Bs:
            reset_launches()
            expl = explainer.explain(X[:B], nsamples="exact", silent=True)
            torch.cuda.synchronize()
            launches = kernel_launches()
            phi, add_err = phi_of(expl, B, M)
            n_cpu = min(B, N_TN_CPU if label == "mid" else 2)
            d_cpu = rel_close(phi[:n_cpu], phi_of(cpu.explain(X[:n_cpu], nsamples="exact",
                                                              silent=True), n_cpu, M)[0],
                              rel=TN_REL)
            wall, runs = median_wall_ms(
                lambda: explainer.explain(X[:B], nsamples="exact", silent=True), 3)
            wall_p, busy, idle, n_events, top = device_busy(
                lambda: explainer.explain(X[:B], nsamples="exact", silent=True))
            flops = B * N * tn_dp_flops(M, rank, 1)
            bound = 1e3 * flops / FP32_FLOPS_PER_S
            print(f"tensor train {label} M={M} rank={rank} N={N} B={B}: launches {launches} "
                  f"(want all 0), kernel_path {explainer.kernel_path}, additivity "
                  f"{add_err:.3e}, |phi card - phi cpu| (first {n_cpu} rows)={d_cpu:.3e} "
                  f"(tol {TN_REL:g} x max(1, max|phi|)); wall median of 3 {wall:.3f} ms "
                  f"(runs {runs}); under torch.profiler wall {wall_p:.3f} ms, busy "
                  f"{busy:.3f} ms, idle {idle:.4f}, {n_events} device events, top {top}; "
                  f"DP {flops:.3e} f32 FLOP, bound {bound:.4f} ms at {FP32_FLOPS_PER_S:.3g} "
                  f"FLOP/s, {100 * bound / wall:.2f}% of the wall, {100 * bound / busy:.2f}% "
                  f"of the busy time; on {card}", flush=True)
            if any(launches.values()) or explainer.kernel_path != {"exact_phi": "tn_dp"}:
                raise AssertionError("the TN explain took another path")
            out[(label, B)] = wall
        if label == "mid":
            engine = explainer._explainer
            want = np.stack(engine.get_explanation(X, nsamples="exact"), 1)
            staged = engine.stage_rows(X, nsamples="exact")
            values, info = engine.get_explanation_async(staged, nsamples="exact")()
            same = bool(np.array_equal(np.stack(values, 1), want))
            on_card = torch.device(device).type == "cuda"
            print(f"tensor train staged B={X.shape[0]}: StagedRows={isinstance(staged, StagedRows)}"
                  f" with event={staged is not None and staged.ready is not None}, "
                  f"bit-identical to sync {same}", flush=True)
            if not (isinstance(staged, StagedRows) and same
                    and (staged.ready is not None or not on_card)):
                raise AssertionError("the staged TN explain disagrees with the sync one")
    cores = tt_cores(TN_BRUTE_M, 4, seed)
    bg = rng.normal(size=(8, TN_BRUTE_M)).astype(np.float32)
    X = rng.normal(size=(2, TN_BRUTE_M)).astype(np.float32)
    phi, _ = phi_of(fit(cores, bg, device).explain(X, nsamples="exact", silent=True),
                    2, TN_BRUTE_M)
    d_bf = rel_close(phi, tt_brute_force(cores, X, bg), rel=TN_REL)
    print(f"tensor train M={TN_BRUTE_M}: |phi card - brute force| (2 rows, 8 background "
          f"rows, {2 ** TN_BRUTE_M} coalitions)={d_bf:.3e}", flush=True)
    return out


def host_wait(fn, busy):
    """``(host ms, syncs)`` of ``fn()`` issued behind ~2 ms of queued device
    work (one ``busy @ busy``): an op that waits for the device, inside
    PyTorch or inside a library, shows that work in its host time; the
    syncs are those ``torch.cuda``'s sync debug mode reports."""

    import warnings

    import torch

    torch.cuda.synchronize()
    busy @ busy
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            fn()
            ms = 1e3 * (time.perf_counter() - t0)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return ms, sum("synchroniz" in str(w.message) for w in caught)


def singular_gram_phase(device):
    """Phase 26: a Gram matrix that is not positive definite gives NaN phi on
    the card without raising (the reference's ``cho_factor``), through
    ``solve_from_normal`` and the WLS of a plan whose weights are all 0;
    then which of the solve's linear-algebra calls wait for the device: each
    one's host time behind ~2 ms of queued work and its reported syncs."""

    import torch
    from distributedkernelshap_tpu_torch.ops.coalitions import coalition_plan
    from distributedkernelshap_tpu_torch.ops.explain import (
        _wls_solve,
        cholesky_or_nan,
        solve_from_factor,
        solve_from_normal,
    )

    rng = np.random.default_rng(26)
    Q, _ = np.linalg.qr(rng.normal(size=(11, 11)))
    A = torch.as_tensor(((Q * np.linspace(-0.5, 2.0, 11)) @ Q.T).astype(np.float32),
                        device=device)
    rhs = torch.as_tensor(rng.normal(size=(4, 2, 11)).astype(np.float32), device=device)
    fme = torch.as_tensor(rng.normal(size=(4, 2)).astype(np.float32), device=device)
    phi = solve_from_normal(A, rhs, fme, 0.0)
    plan = coalition_plan(len(ADULT_WIDTHS), nsamples=64, seed=0)
    mask = torch.as_tensor(plan.mask, device=device)
    phi_w = _wls_solve(mask, torch.zeros(plan.n_rows, device=device),
                       torch.as_tensor(rng.normal(size=(4, plan.n_rows, 2)).astype(np.float32),
                                       device=device), fme, 0.0)
    nan_a, nan_w = bool(phi.isnan().all()), bool(phi_w.isnan().all())
    print(f"singular Gram: solve_from_normal on an indefinite (M-1)={A.shape[0]} Gram -> all "
          f"NaN {nan_a}; WLS of an all-zero-weight plan -> all NaN {nan_w}; nothing raised",
          flush=True)
    if not (nan_a and nan_w):
        raise AssertionError("a singular Gram did not give NaN phi")

    busy = torch.randn(4096, 4096, device=device)
    P = torch.as_tensor(((Q * np.linspace(0.5, 2.0, 11)) @ Q.T).astype(np.float32),
                        device=device)
    L = cholesky_or_nan(P)
    R = rhs.reshape(8, 11).T.contiguous()
    calls = {
        "cholesky_ex": lambda: torch.linalg.cholesky_ex(P),
        "cholesky_or_nan": lambda: cholesky_or_nan(P),
        "cholesky_solve": lambda: torch.cholesky_solve(R, L),
        "solve_triangular x2": lambda: torch.linalg.solve_triangular(
            L.T, torch.linalg.solve_triangular(L, R, upper=False), upper=True),
        "solve_from_factor": lambda: solve_from_factor(L, rhs, fme),
        "solve_from_normal": lambda: solve_from_normal(P, rhs, fme, 1e-6),
    }
    waits = {name: host_wait(fn, busy) for name, fn in calls.items()}
    print("host time (ms) and syncs behind ~2 ms of queued device work: " + "; ".join(
        f"{name} {ms:.3f} ms, {n} syncs" for name, (ms, n) in waits.items()), flush=True)
    return waits


def wls_host_phase(explainer, X, card):
    """Phase 27: the headline explain's WLS host time with the NaN-safe
    factor: ``ops.explain._wls_solve`` wrapped in a host clock (no sync of
    its own) over 5 explains at B = 2560, beside the explain wall (phase 26
    says which of its calls, if any, wait for the device)."""

    import torch
    from distributedkernelshap_tpu_torch.ops import explain as ops_explain

    real, spans = ops_explain._wls_solve, []

    def timed(*a, **k):
        t0 = time.perf_counter()
        out = real(*a, **k)
        spans.append(1e3 * (time.perf_counter() - t0))
        return out

    ops_explain._wls_solve = timed
    try:
        wall, runs = median_wall_ms(lambda: explainer.explain(X, silent=True), 5)
    finally:
        ops_explain._wls_solve = real
    torch.cuda.synchronize()
    print(f"headline WLS host time with the NaN-safe factor: median "
          f"{statistics.median(spans):.4f} ms over {len(spans)} explains (spans "
          f"{[round(v, 4) for v in spans]}); explain wall median of 5 {wall:.3f} ms "
          f"(runs {runs}) on {card}", flush=True)
    return statistics.median(spans), wall


def fixture_phase(device, card):
    """Phase 28: the JAX package's own answers on the Adult-schema synthetic
    rows (``tests/fixtures/adult_parity.npz``, read with numpy; made by
    ``scripts/make_adult_parity_fixture.py``): the headline LR explain of all
    2560 rows on the card against the JAX phi (``PHI_ATOL``), E and f(x)
    (2e-5), and the ``adult_trees_exact`` GBT's exact phi and interaction
    matrices (first 256 rows, counted) within ``PHI_REL``."""

    import torch
    from distributedkernelshap_tpu_torch import TreeEnsemblePredictor

    import os

    fx = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), FIXTURE),
                 allow_pickle=False)
    widths = [int(w) for w in fx["group_widths"]]
    starts = np.concatenate([[0], np.cumsum(widths)[:-1]])
    groups = [list(range(s, s + w)) for s, w in zip(starts, widths)]
    names = [f"g{i}" for i in range(len(widths))]
    est = AdultShapedLogisticRegression.fitted(fx["coef"], fx["intercept"])
    from distributedkernelshap_tpu_torch import KernelShap

    X, bg = fx["X"], fx["background"]
    explainer = KernelShap(est.predict_proba, link="logit", seed=0, device=device)
    explainer.fit(bg, group_names=names, groups=groups)
    reset_launches()
    expl = explainer.explain(X, silent=True)
    torch.cuda.synchronize()
    launches = kernel_launches()
    phi = np.stack(expl.shap_values, 1)
    # the logit link turns one f32 ulp of p into 2^-24 / (p (1 - p)) of
    # logit: a row's tolerance adds LOGIT_ULPS such ulps at its f(x)
    ulp = 2.0 ** -24 * (2.0 + 2.0 * np.cosh(fx["raw_prediction"][:, 1]))
    d_phi = np.abs(phi - fx["phi"]).max((1, 2))
    d_fx = np.abs(expl.data["raw"]["raw_prediction"] - fx["raw_prediction"]).max(1)
    d_e = float(np.abs(np.asarray(expl.expected_value) - fx["expected_value"]).max())
    phi_ok = d_phi <= PHI_ATOL + LOGIT_ULPS * ulp
    fx_ok = d_fx <= 2e-5 + LOGIT_ULPS * ulp
    worst = int(np.argmax(d_phi))
    print(f"fixture ({FIXTURE}, provenance {fx['provenance']}): headline B={X.shape[0]} "
          f"launches {launches}, kernel_path {explainer.kernel_path}; |phi card - phi JAX| "
          f"max {d_phi.max():.3e} (row {worst}, f(x)={fx['raw_prediction'][worst, 1]:.3f}, "
          f"tol {PHI_ATOL:g} + {LOGIT_ULPS} p-ulps = "
          f"{PHI_ATOL + LOGIT_ULPS * ulp[worst]:.3e}), rows within {PHI_ATOL:g} alone "
          f"{int((d_phi <= PHI_ATOL).sum())}/{X.shape[0]}; |f(x) - f(x) JAX| max "
          f"{d_fx.max():.3e} (2e-5 + {LOGIT_ULPS} p-ulps: {int(fx_ok.sum())} rows within); "
          f"|E - E JAX|={d_e:.3e} (tol 2e-5)", flush=True)
    if launches["fused_linear_ey"] < 1 or not (phi_ok.all() and fx_ok.all() and d_e <= 2e-5):
        raise AssertionError("the headline disagrees with the JAX package's fixture")
    tree = TreeEnsemblePredictor(
        fx["tree_feature"], fx["tree_threshold"], fx["tree_left"], fx["tree_right"],
        fx["tree_value"], depth=int(fx["tree_depth"]), aggregation="sum",
        base=fx["tree_base"], scale=float(fx["tree_scale"]),
        missing_left=fx["tree_missing_left"], vector_out=False, device=device)
    explainer = KernelShap(tree, task="regression", seed=0, device=device)
    explainer.fit(bg, group_names=names, groups=groups)
    n = fx["tree_phi"].shape[0]
    reset_launches()
    expl = explainer.explain(X[:n], nsamples="exact", interactions=True, silent=True)
    torch.cuda.synchronize()
    launches = kernel_launches()
    d_phi = rel_close(np.asarray(expl.shap_values[0]), fx["tree_phi"])
    d_inter = rel_close(expl.data["raw"]["interaction_values"][0], fx["tree_interactions"])
    d_e = abs(float(np.ravel(expl.expected_value)[0]) - float(fx["tree_expected_value"][0]))
    print(f"fixture adult_trees_exact GBT (T={tree.n_trees}) B={n}: launches {launches} "
          f"(want 1 + 1), |phi card - phi JAX|={d_phi:.3e}, |inter card - inter JAX|="
          f"{d_inter:.3e} (tol {PHI_REL:g} x max(1, max|.|)), |E - E JAX|={d_e:.3e} "
          f"on {card}", flush=True)
    if launches["exact_tree_inter"] != 1 or launches["exact_tree_phi"] != 1 or d_e > 1e-5:
        raise AssertionError("the fixture GBT's exact explain is off")


# ---------------------------------------------------------------------- #
# the eighth slice (phases 29-33): scikit-learn stand-ins.  The card's
# machine has no scikit-learn, so each stand-in is a class named as
# scikit-learn names it (the lifters dispatch on ``type(owner).__name__``)
# carrying the fitted attributes the lifters read, with numpy methods that
# compute what scikit-learn's do; the lift's probe holds the lifted model
# against those methods.


def _expit(z):
    return 1.0 / (1.0 + np.exp(-z))


class StandardScaler:
    def __init__(self, mean, scale):
        self.mean_, self.scale_ = np.asarray(mean, np.float64), np.asarray(scale, np.float64)
        self.n_features_in_ = self.mean_.shape[0]
        self.with_mean = self.with_std = True

    def transform(self, X):
        return (np.asarray(X, np.float64) - self.mean_) / self.scale_


class SimpleImputer:
    missing_values = np.nan
    add_indicator = False

    def __init__(self, statistics):
        self.statistics_ = np.asarray(statistics, np.float64)

    def transform(self, X):
        X = np.asarray(X, np.float64)
        return np.where(np.isnan(X), self.statistics_[None, :], X)


class LogisticRegression:
    """Binary: ``coef_ (1, D)``, ``intercept_ (1,)``."""

    classes_ = np.arange(2)

    def __init__(self, coef, intercept):
        self.coef_ = np.asarray(coef, np.float64).reshape(1, -1)
        self.intercept_ = np.asarray(intercept, np.float64).reshape(1)

    def decision_function(self, X):
        return (np.asarray(X, np.float64) @ self.coef_.T + self.intercept_)[:, 0]

    def predict_proba(self, X):
        p = _expit(self.decision_function(X))[:, None]
        return np.hstack([1.0 - p, p])


class LinearSVC(LogisticRegression):
    pass


class Pipeline:
    def __init__(self, steps):
        self.steps = list(steps)

    def _rows(self, X):
        for _, tf in self.steps[:-1]:
            X = tf.transform(X)
        return X

    def predict_proba(self, X):
        return self.steps[-1][1].predict_proba(self._rows(X))

    def decision_function(self, X):
        return self.steps[-1][1].decision_function(self._rows(X))

    def predict(self, X):
        return self.steps[-1][1].predict(self._rows(X))


class GridSearchCV:
    def __init__(self, best):
        self.best_estimator_ = best

    def predict_proba(self, X):
        return self.best_estimator_.predict_proba(X)


class SVC:
    """Binary ``SVC`` (``dual_coef_ (1, V)``); the kernel expansion in
    float64."""

    def __init__(self, sv, dual, intercept, gamma, kernel="rbf", coef0=0.0, degree=3):
        self.support_vectors_ = np.asarray(sv, np.float64)
        self.dual_coef_ = np.asarray(dual, np.float64).reshape(1, -1)
        self.intercept_ = np.asarray(intercept, np.float64).reshape(1)
        self._gamma, self.kernel, self.coef0, self.degree = float(gamma), kernel, coef0, degree

    def decision_function(self, X):
        X = np.asarray(X, np.float64)
        sv = self.support_vectors_
        G = X @ sv.T
        if self.kernel == "rbf":
            d2 = (X ** 2).sum(1)[:, None] + (sv ** 2).sum(1)[None, :] - 2.0 * G
            k = np.exp(-self._gamma * np.maximum(d2, 0.0))
        elif self.kernel == "poly":
            k = (self._gamma * G + self.coef0) ** self.degree
        elif self.kernel == "sigmoid":
            k = np.tanh(self._gamma * G + self.coef0)
        else:
            k = G
        return k @ self.dual_coef_[0] + self.intercept_[0]


class _SigmoidCalibration:
    def __init__(self, a, b):
        self.a_, self.b_ = float(a), float(b)

    def predict(self, f):
        return 1.0 / (1.0 + np.exp(self.a_ * f + self.b_))


class IsotonicRegression:
    def __init__(self, xs, ys):
        self.X_thresholds_ = np.asarray(xs, np.float64)
        self.y_thresholds_ = np.asarray(ys, np.float64)

    def predict(self, f):
        xs = self.X_thresholds_
        return np.interp(np.clip(f, xs[0], xs[-1]), xs, self.y_thresholds_)


class _CalibratedClassifier:
    def __init__(self, estimator, calibrator):
        self.estimator, self.calibrators = estimator, [calibrator]


class CalibratedClassifierCV:
    """Binary, one ``(LinearSVC, calibrator)`` pair per fold; the mean of
    the folds' calibrated probabilities."""

    classes_ = np.arange(2)

    def __init__(self, folds):
        self.calibrated_classifiers_ = [_CalibratedClassifier(e, c) for e, c in folds]

    def predict_proba(self, X):
        p = np.mean([cc.calibrators[0].predict(cc.estimator.decision_function(X))
                     for cc in self.calibrated_classifiers_], axis=0)[:, None]
        return np.hstack([1.0 - p, p])


class GaussianNB:
    def __init__(self, theta, var, prior):
        self.theta_, self.var_ = np.asarray(theta, np.float64), np.asarray(var, np.float64)
        self.class_prior_ = np.asarray(prior, np.float64)

    def predict_proba(self, X):
        X = np.asarray(X, np.float64)
        jll = (np.log(self.class_prior_)[None, :]
               - 0.5 * np.sum(np.log(2.0 * np.pi * self.var_), axis=1)[None, :]
               - 0.5 * (((X[:, None, :] - self.theta_[None]) ** 2) / self.var_[None]).sum(-1))
        return _softmax(jll)


class QuadraticDiscriminantAnalysis:
    def __init__(self, means, rotations, scalings, priors):
        self.means_ = np.asarray(means, np.float64)
        self.rotations_ = [np.asarray(r, np.float64) for r in rotations]
        self.scalings_ = [np.asarray(s, np.float64) for s in scalings]
        self.priors_ = np.asarray(priors, np.float64)

    def predict_proba(self, X):
        X = np.asarray(X, np.float64)
        cols = []
        for k in range(self.means_.shape[0]):
            X2 = (X - self.means_[k]) @ (self.rotations_[k] * self.scalings_[k] ** -0.5)
            cols.append(-0.5 * ((X2 ** 2).sum(1) + np.log(self.scalings_[k]).sum())
                        + np.log(self.priors_[k]))
        return _softmax(np.stack(cols, 1))


def _softmax(z):
    e = np.exp(z - z.max(1, keepdims=True))
    return e / e.sum(1, keepdims=True)


class VotingClassifier:
    voting = "soft"

    def __init__(self, estimators, weights):
        self.estimators_, self._weights_not_none = list(estimators), list(weights)

    def predict_proba(self, X):
        return np.average([e.predict_proba(X) for e in self.estimators_], axis=0,
                          weights=self._weights_not_none)


class OneVsRestClassifier:
    def __init__(self, estimators, multilabel):
        self.estimators_, self.multilabel_ = list(estimators), multilabel

    def predict_proba(self, X):
        P = np.stack([e.predict_proba(X)[:, 1] for e in self.estimators_], 1)
        return P if self.multilabel_ else P / P.sum(1, keepdims=True)


class BaggingClassifier:
    def __init__(self, estimators, features, n_features):
        self.estimators_, self.estimators_features_ = list(estimators), list(features)
        self.n_features_in_ = n_features

    def predict_proba(self, X):
        X = np.asarray(X, np.float64)
        return np.mean([e.predict_proba(X[:, f]) for e, f in
                        zip(self.estimators_, self.estimators_features_)], axis=0)


class StackingClassifier:
    """Binary: each member's positive probability (scikit-learn drops the
    first column), then the raw rows when ``passthrough``."""

    classes_ = np.arange(2)

    def __init__(self, estimators, final, passthrough):
        self.estimators_, self.final_estimator_ = list(estimators), final
        self.stack_method_ = ["predict_proba"] * len(self.estimators_)
        self.passthrough = passthrough

    def predict_proba(self, X):
        X = np.asarray(X, np.float64)
        cols = [e.predict_proba(X)[:, 1:2] for e in self.estimators_]
        return self.final_estimator_.predict_proba(np.hstack(cols + ([X] if self.passthrough
                                                                    else [])))


class _Tree:
    """The ``tree_`` of a depth-1 ``DecisionTreeClassifier``."""

    n_outputs, node_count = 1, 3

    def __init__(self, feature, threshold, left, right):
        self.feature = np.array([feature, -2, -2])
        self.threshold = np.array([threshold, -2.0, -2.0])
        self.children_left = np.array([1, -1, -1])
        self.children_right = np.array([2, -1, -1])
        self.value = np.array([[[0.5, 0.5]], [left], [right]], np.float64)


class DecisionTreeClassifier:
    classes_ = np.arange(2)

    def __init__(self, feature, threshold, left, right):
        self.tree_ = _Tree(feature, threshold, left, right)

    def predict_proba(self, X):
        t = self.tree_
        go_left = np.asarray(X, np.float64)[:, t.feature[0]] <= t.threshold[0]
        return np.where(go_left[:, None], t.value[1, 0][None], t.value[2, 0][None])


class AdaBoostClassifier:
    """Binary SAMME, scikit-learn's ``decision_function`` and
    ``_compute_proba_from_decision``."""

    algorithm = "SAMME"
    classes_ = np.arange(2)

    def __init__(self, estimators, weights):
        self.estimators_ = list(estimators)
        self.estimator_weights_ = np.asarray(weights, np.float64)

    def decision_function(self, X):
        pred = sum(np.where((np.argmax(e.predict_proba(X), 1)[None, :]
                             == self.classes_[:, None]).T, w, -w)
                   for e, w in zip(self.estimators_, self.estimator_weights_))
        pred = pred / self.estimator_weights_.sum()
        return pred[:, 1] - pred[:, 0]

    def predict_proba(self, X):
        d = self.decision_function(X)
        return _softmax(np.stack([-d, d], 1) / 2.0)


class TransformedTargetRegressor:
    def __init__(self, regressor, transformer):
        self.regressor_, self.transformer_ = regressor, transformer

    def predict(self, X):
        t = self.transformer_
        return self.regressor_.predict(X) * t.scale_[0] + t.mean_[0]


@contextlib.contextmanager
def recorded_ey_calls():
    """Inside the block, every ``fused_linear_ey`` call of the explain path
    (``ops.explain`` imports the wrapper by name) appends its arguments to
    the yielded list; the kernel still launches and counts."""

    from distributedkernelshap_tpu_torch.ops import explain as explain_mod

    kernel, calls = explain_mod.fused_linear_ey, []

    def recorded(*a, **k):
        calls.append((a, k))
        return kernel(*a, **k)

    explain_mod.fused_linear_ey = recorded
    try:
        yield calls
    finally:
        explain_mod.fused_linear_ey = kernel


def kernel_vs_plain_on(calls) -> float:
    """``fused_linear_ey`` against its plain version on each recorded call's
    own arguments (these launches come after a path's counts were read);
    the worst difference, which must be within ``EY_ATOL``."""

    from distributedkernelshap_tpu_torch.ops.cuda_kernels import (
        fused_linear_ey,
        fused_linear_ey_plain,
    )

    worst = 0.0
    for a, k in calls:
        worst = max(worst, float((fused_linear_ey(*a, **k)
                                  - fused_linear_ey_plain(*a, **k)).abs().max()))
    if not worst <= EY_ATOL:
        raise AssertionError(f"fused_linear_ey vs plain {worst:.3e} on a new path's inputs")
    return worst


def logit_tol(raw):
    """Phase 28's tolerance of logit-space phi per row: ``PHI_ATOL`` plus
    ``LOGIT_ULPS`` f32 ulps of p at the row's f(x) (ROADMAP C.9)."""

    return PHI_ATOL + LOGIT_ULPS * 2.0 ** -24 * (2.0 + 2.0 * np.cosh(raw))


def pipeline_phase(X, bg, device, card, seed):
    """Phase 29: ``Pipeline(StandardScaler, LogisticRegression)`` at the
    headline shape (B = 2560): it lifts to ONE ``LinearPredictor`` whose
    ``W`` and ``b`` equal the fold computed here in numpy float64 (the
    formula of ``models/compose._compose_linear``); its explain launches
    ``fused_linear_ey`` once on the kernel path ``'cuda'`` and agrees with
    the bare LR explained on the pre-scaled rows and background; a
    ``GridSearchCV`` over the pipeline lifts to the same ``W`` and ``b``;
    the kernel against its plain version on the pipeline's arguments.
    Returns that difference."""

    import torch
    from distributedkernelshap_tpu_torch.models import LinearPredictor, as_predictor

    rng = np.random.default_rng([seed, 29])
    D = X.shape[1]
    sample = adult_shaped_rows(rng, 1000).astype(np.float64)
    scaler = StandardScaler(sample.mean(0), sample.std(0) + 0.05)
    lr = LogisticRegression(rng.normal(scale=0.3, size=(1, D)), [-0.5])
    pipe = Pipeline([("sc", scaler), ("lr", lr)])
    f32, f64 = np.float32, np.float64
    a = np.asarray(1.0 / scaler.scale_, f32).astype(f64)
    c = np.asarray(-scaler.mean_ / scaler.scale_, f32).astype(f64)
    coef = np.asarray(lr.coef_, f32)
    W_in = np.concatenate([np.zeros_like(coef), coef], 0).T.astype(f64)
    b_in = np.asarray([0.0, np.float32(lr.intercept_[0])], f64)
    Mx = np.eye(D, dtype=f64) * a[None, :]
    v = np.zeros(D, dtype=f64) * a + c
    W_fold, b_fold = (Mx @ W_in).astype(f32), (v @ W_in + b_in).astype(f32)

    reset_launches()
    with recorded_ey_calls() as calls:
        explainer, expl = explain_sampled(pipe.predict_proba, X, bg, device)
        torch.cuda.synchronize()
    launches, path = kernel_launches(), explainer.kernel_path
    lifted = explainer._explainer.predictor
    folded = isinstance(lifted, LinearPredictor) and np.array_equal(
        lifted.W.cpu().numpy(), W_fold) and np.array_equal(lifted.b.cpu().numpy(), b_fold)
    phi, add_err = sampled_phi(expl, X.shape[0])
    Xs, bgs = scaler.transform(X).astype(f32), scaler.transform(bg).astype(f32)
    bare, expl_bare = explain_sampled(lr.predict_proba, Xs, bgs, device)
    raw = expl_bare.data["raw"]["raw_prediction"][:, 1]
    d_bare = np.abs(phi - sampled_phi(expl_bare, X.shape[0])[0]).max((1, 2))
    bare_ok = bool((d_bare <= logit_tol(raw)).all())
    gs = GridSearchCV(pipe)
    searched = as_predictor(gs.predict_proba, example_dim=D, probe_data=bg, device=device)
    same_search = isinstance(searched, LinearPredictor) and torch.equal(
        searched.W, lifted.W) and torch.equal(searched.b, lifted.b)
    err = kernel_vs_plain_on(calls)
    wall, runs = median_wall_ms(lambda: explainer.explain(X, silent=True), 3)
    wall_bare, runs_bare = median_wall_ms(lambda: bare.explain(Xs, silent=True), 3)
    print(f"pipeline: Pipeline(StandardScaler, LogisticRegression) B={X.shape[0]} lifted to "
          f"{type(lifted).__name__}, W and b equal to the numpy float64 fold: {folded}; "
          f"launches {launches} (want fused_linear_ey=1), kernel_path {path}, additivity "
          f"{add_err:.3e}; |phi - phi of the bare LR on pre-scaled rows| max "
          f"{d_bare.max():.3e} (tol {PHI_ATOL:g} + {LOGIT_ULPS} p-ulps; logits in "
          f"[{raw.min():.2f}, {raw.max():.2f}]); GridSearchCV lifts to the same W, b: "
          f"{same_search}; fused_linear_ey vs plain on its inputs {err:.3e}; wall median of 3 "
          f"{wall:.3f} ms (runs {runs}), bare LR {wall_bare:.3f} ms (runs {runs_bare}) on "
          f"{card}", flush=True)
    if not (folded and launches["fused_linear_ey"] == 1 and path == {"ey": "cuda"}
            and bare_ok and same_search):
        raise AssertionError("the folded pipeline is off")
    return err


def svm_phase(X_all, bg, device, card, seed):
    """Phase 30: ``SVC`` stand-ins over ``N_SV`` seeded Adult-shaped support
    vectors (rbf, linear, poly of degree 3, sigmoid; gamma 'scale') lifted
    through ``KernelShap(svc.decision_function)`` and explained at
    ``B_ZOO`` through ``masked_ey`` with ``link='identity'``: additive, no
    hand kernel; at ``B_SVM_GENERIC`` the same explain through the generic
    route (the lifted SVM wrapped as a ``TorchPredictor``) within
    ``SVM_GENERIC_REL · max(1, max|phi|)``; the rbf wall, its device busy
    time and the share of its FLOP bound (2·S·B·N·V for the factorised
    contraction)."""

    import torch
    from distributedkernelshap_tpu_torch import EngineConfig, TorchPredictor
    from distributedkernelshap_tpu_torch.models import SVMPredictor
    from distributedkernelshap_tpu_torch.ops.explain import ShapConfig

    rng = np.random.default_rng([seed, 30])
    sv = adult_shaped_rows(rng, N_SV).astype(np.float64)
    dual = rng.uniform(-1.0, 1.0, size=N_SV) * 0.05
    gamma = 1.0 / (sv.shape[1] * sv.var())
    X = X_all[:B_ZOO]
    for kernel in ("rbf", "linear", "poly", "sigmoid"):
        svc = SVC(sv, dual, [0.1], gamma, kernel=kernel)
        t0 = time.perf_counter()
        reset_launches()
        explainer, expl = explain_sampled(svc.decision_function, X, bg, device,
                                          link="identity")
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        launches, path = kernel_launches(), explainer.kernel_path
        lifted = explainer._explainer.predictor
        phi, add_err = sampled_phi(expl, B_ZOO, K=1)
        with torch.no_grad():
            got = lifted(torch.as_tensor(X, device=device)).cpu().numpy()[:, 0]
        want = svc.decision_function(X)
        d_pred = float(np.abs(got - want).max())
        small = X[:B_SVM_GENERIC]
        phi_m = sampled_phi(explainer.explain(small, silent=True), B_SVM_GENERIC, K=1)[0]
        gen, expl_g = explain_sampled(
            TorchPredictor(lifted, n_outputs=1, vector_out=False, device=device), small, bg,
            device, link="identity", engine_config=EngineConfig(
                shap=ShapConfig(target_chunk_elems=1 << 22)))
        phi_g = sampled_phi(expl_g, B_SVM_GENERIC, K=1)[0]
        d_gen = float(np.abs(phi_m - phi_g).max())
        tol = SVM_GENERIC_REL * max(1.0, float(np.abs(phi_g).max()))
        print(f"svm {kernel}: V={N_SV} gamma={gamma:.4f} lifted to {type(lifted).__name__}, "
              f"|f lifted - f numpy| {d_pred:.3e}; B={B_ZOO} launches {launches} (want all "
              f"0), kernel_path {path}, additivity {add_err:.3e}, max|phi| "
              f"{np.abs(phi).max():.3f}; B={B_SVM_GENERIC} masked_ey vs the generic route "
              f"({gen.kernel_path}) {d_gen:.3e} (tol {tol:.2e}); first explain "
              f"{1e3 * first:.1f} ms", flush=True)
        if not (isinstance(lifted, SVMPredictor) and path == {"ey": "masked_ey"}
                and not any(launches.values()) and gen.kernel_path == {"ey": "generic"}
                and d_gen <= tol and d_pred <= ZOO_PRED_REL * max(1.0, np.abs(want).max())):
            raise AssertionError(f"the {kernel} SVM explain is off")
        if kernel == "rbf":
            wall, runs = median_wall_ms(lambda: explainer.explain(X, silent=True), 3)
            p_wall, busy, idle, events, top = device_busy(
                lambda: explainer.explain(X, silent=True))
            S = explainer._explainer._plan(None).n_rows
            bound = 1e3 * 2.0 * S * B_ZOO * N_BACKGROUND * N_SV / FP32_FLOPS_PER_S
            print(f"times on {card}: rbf SVM explain B={B_ZOO} V={N_SV} wall median of 3 "
                  f"{wall:.3f} ms (runs {runs}); under torch.profiler wall {p_wall:.3f} ms, "
                  f"device busy {busy:.3f} ms, idle share {idle:.4f}, {events} device events, "
                  f"most device time {top}; FLOP bound of the factorised contraction "
                  f"(2·S·B·N·V = {2.0 * S * B_ZOO * N_BACKGROUND * N_SV:.3e} f32 FLOP) "
                  f"{bound:.3f} ms = {100 * bound / wall:.1f}% of the wall, "
                  f"{100 * bound / busy:.1f}% of the busy time", flush=True)


def ensemble_members(tables, X_all, device, seed):
    """Phase 31's and 32's members: a binary LR stand-in and phase 6's GBT
    behind an ``XGBClassifier`` stand-in (its binary:logistic dump, the
    lift of phase 22)."""

    rng = np.random.default_rng([seed, 31])
    lr = LogisticRegression(rng.normal(scale=0.3, size=(1, X_all.shape[1])), [-0.4])
    seeded = tree_predictor(tables, device, head="binary_sigmoid")
    gbt = booster_owner("XGBClassifier",
                        xgboost_json(tables, "binary:logistic", _expit(GBT_BASE)),
                        numpy_fn(seeded, device))
    return lr, gbt, rng


def ensemble_phase(tables, X_all, bg, device, card, seed):
    """Phase 31: the forwarding compositions at ``B_ENSEMBLE`` with
    ``link='identity'``: soft voting (LR, GBT) with weights
    ``VOTING_WEIGHTS`` takes ``masked_ey``, launches ``fused_linear_ey``
    once and its phi is the weighted sum of the members' phi;
    ``Pipeline(SimpleImputer, GBT)`` on NaN-free rows forwards the tree's
    ``masked_ey`` with phi bit-identical to the bare GBT's; multilabel
    one-vs-rest over 3 LRs launches the kernel 3 times; bagging over
    ``N_BAG`` LRs on feature subsets forwards through select stages (one
    launch each) and agrees with the generic route.  Each linear member's
    kernel against its plain version.  Returns the worst difference."""

    import torch
    from distributedkernelshap_tpu_torch import TorchPredictor
    from distributedkernelshap_tpu_torch.models import (
        MeanEnsemblePredictor,
        OneVsRestPredictor,
        PipelinePredictor,
    )

    X = X_all[:B_ENSEMBLE]
    lr, gbt, rng = ensemble_members(tables, X_all, device, seed)
    worst = 0.0

    def counted(model):
        reset_launches()
        t0 = time.perf_counter()
        with recorded_ey_calls() as calls:
            explainer, expl = explain_sampled(model, X, bg, device, link="identity")
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        return explainer, expl, kernel_launches(), secs, calls

    voting = VotingClassifier([lr, gbt], VOTING_WEIGHTS)
    ex_v, expl_v, launches, secs, calls = counted(voting.predict_proba)
    phi_v, add_err = sampled_phi(expl_v, B_ENSEMBLE)
    _, expl_lr, _, _, _ = counted(lr.predict_proba)
    _, expl_gb, _, _, _ = counted(gbt.predict_proba)
    phi_lr, phi_gb = sampled_phi(expl_lr, B_ENSEMBLE)[0], sampled_phi(expl_gb, B_ENSEMBLE)[0]
    mix = VOTING_WEIGHTS[0] * phi_lr + VOTING_WEIGHTS[1] * phi_gb
    d_mix = float(np.abs(phi_v - mix).max())
    tol = ENSEMBLE_REL * max(1.0, float(np.abs(mix).max()))
    lifted = ex_v._explainer.predictor
    err = kernel_vs_plain_on(calls)
    worst = max(worst, err)
    print(f"ensembles: soft voting (LR, GBT) weights {VOTING_WEIGHTS} B={B_ENSEMBLE} lifted to "
          f"{type(lifted).__name__}; launches {launches} (want fused_linear_ey=1), kernel_path "
          f"{ex_v.kernel_path}, additivity {add_err:.3e}, |phi - (w0 phi LR + w1 phi GBT)| "
          f"{d_mix:.3e} (tol {tol:.2e}); member kernel vs plain {err:.3e}; first explain "
          f"{1e3 * secs:.1f} ms", flush=True)
    if not (isinstance(lifted, MeanEnsemblePredictor) and launches["fused_linear_ey"] == 1
            and ex_v.kernel_path == {"ey": "masked_ey"} and d_mix <= tol):
        raise AssertionError("the soft-voting explain is off")

    imputer = SimpleImputer(rng.normal(size=X.shape[1]))
    pipe = Pipeline([("imp", imputer), ("gb", gbt)])
    ex_p, expl_p, launches, secs, _ = counted(pipe.predict_proba)
    same = np.array_equal(sampled_phi(expl_p, B_ENSEMBLE)[0], phi_gb)
    lifted = ex_p._explainer.predictor
    print(f"ensembles: Pipeline(SimpleImputer, GBT) lifted to {type(lifted).__name__}, "
          f"launches {launches} (want all 0), kernel_path {ex_p.kernel_path}, phi "
          f"bit-identical to the bare GBT's: {same}; first explain {1e3 * secs:.1f} ms",
          flush=True)
    if not (isinstance(lifted, PipelinePredictor) and same and not any(launches.values())
            and ex_p.kernel_path == {"ey": "masked_ey"}):
        raise AssertionError("the imputer pipeline did not forward the tree's masked_ey")

    lrs = [LogisticRegression(rng.normal(scale=0.3, size=(1, X.shape[1])), [c])
           for c in (-0.5, 0.0, 0.5)]
    ovr = OneVsRestClassifier(lrs, multilabel=True)
    ex_o, expl_o, launches, secs, calls = counted(ovr.predict_proba)
    _, add_err = sampled_phi(expl_o, B_ENSEMBLE, K=3)
    lifted = ex_o._explainer.predictor
    worst = max(worst, kernel_vs_plain_on(calls))
    print(f"ensembles: multilabel one-vs-rest over 3 LRs lifted to {type(lifted).__name__} "
          f"(normalise {lifted.normalise}), launches {launches} (want fused_linear_ey=3), "
          f"kernel_path {ex_o.kernel_path}, additivity {add_err:.3e}; members' kernel vs "
          f"plain {worst:.3e}; first explain {1e3 * secs:.1f} ms", flush=True)
    if not (isinstance(lifted, OneVsRestPredictor) and launches["fused_linear_ey"] == 3
            and ex_o.kernel_path == {"ey": "masked_ey"}):
        raise AssertionError("the multilabel one-vs-rest explain is off")

    feats = [np.sort(rng.choice(X.shape[1], BAG_FEATURES, replace=False))
             for _ in range(N_BAG)]
    members = [LogisticRegression(rng.normal(scale=0.4, size=(1, BAG_FEATURES)), [0.1])
               for _ in range(N_BAG)]
    bag = BaggingClassifier(members, feats, X.shape[1])
    ex_b, expl_b, launches, secs, calls = counted(bag.predict_proba)
    phi_b, add_err = sampled_phi(expl_b, B_ENSEMBLE)
    lifted = ex_b._explainer.predictor
    worst = max(worst, kernel_vs_plain_on(calls))
    _, expl_g = explain_sampled(TorchPredictor(lifted, n_outputs=2, device=device), X, bg,
                                device, link="identity")
    d_gen = float(np.abs(phi_b - sampled_phi(expl_g, B_ENSEMBLE)[0]).max())
    tol = ENSEMBLE_REL * max(1.0, float(np.abs(phi_b).max()))
    selects = sum(isinstance(m, PipelinePredictor) for m in lifted.members)
    print(f"ensembles: bagging {N_BAG} LRs on {BAG_FEATURES}-column subsets lifted to "
          f"{type(lifted).__name__} ({selects} select stages), launches {launches} (want "
          f"fused_linear_ey={N_BAG}), kernel_path {ex_b.kernel_path}, additivity "
          f"{add_err:.3e}, |phi - generic route phi| {d_gen:.3e} (tol {tol:.2e}); members' "
          f"kernel vs plain {worst:.3e}; first explain {1e3 * secs:.1f} ms on {card}",
          flush=True)
    if not (isinstance(lifted, MeanEnsemblePredictor) and selects == N_BAG
            and launches["fused_linear_ey"] == N_BAG and ex_b.kernel_path == {"ey": "masked_ey"}
            and d_gen <= tol):
        raise AssertionError("the bagging explain is off")
    return worst


def family_models(tables, X_all, device, seed):
    """Phase 32's stand-ins: ``(name, method, lifted class, link)``."""

    lr, gbt, _ = ensemble_members(tables, X_all, device, seed)
    rng = np.random.default_rng([seed, 32])
    D = X_all.shape[1]

    def svcs():
        return [LinearSVC(rng.normal(scale=0.3, size=(1, D)), [rng.normal(scale=0.2)])
                for _ in range(3)]

    sig = CalibratedClassifierCV([(m, _SigmoidCalibration(-1.6 + 0.2 * i, 0.1 * i))
                                  for i, m in enumerate(svcs())])
    iso = CalibratedClassifierCV([(m, IsotonicRegression(
        np.sort(rng.uniform(-4.0, 4.0, 40)), np.sort(rng.uniform(0.02, 0.98, 40))))
        for m in svcs()])
    final = LogisticRegression(rng.normal(scale=0.3, size=(1, 2 + D)), [-0.2])
    stack = StackingClassifier([lr, gbt], final, passthrough=True)
    stumps = []
    for _ in range(N_STUMPS):
        f = int(rng.integers(0, D))
        thr = float(np.float32(rng.normal(scale=0.5) if f < 4 else 0.5))
        p, q = rng.uniform(0.05, 0.45), rng.uniform(0.55, 0.95)
        left, right = ([p, 1 - p], [q, 1 - q]) if rng.random() < 0.5 else ([q, 1 - q],
                                                                           [p, 1 - p])
        stumps.append(DecisionTreeClassifier(f, thr, left, right))
    ada = AdaBoostClassifier(stumps, rng.uniform(0.2, 1.5, N_STUMPS))
    seeded = tree_predictor(tables, device)
    reg = booster_owner("XGBRegressor", xgboost_json(tables), numpy_fn(seeded, device,
                                                                        scalar=True))
    ttr = TransformedTargetRegressor(reg, StandardScaler([3.0], [2.5]))
    nb = GaussianNB(rng.normal(scale=0.3, size=(2, D)), rng.uniform(1.0, 3.0, (2, D)),
                    [0.6, 0.4])
    rot = [np.linalg.qr(rng.normal(size=(D, D)))[0] for _ in range(2)]
    qda = QuadraticDiscriminantAnalysis(rng.normal(scale=0.2, size=(2, D)), rot,
                                        [rng.uniform(2.0, 6.0, D) for _ in range(2)], [0.5, 0.5])
    return [("calibrated sigmoid", sig.predict_proba, "MeanEnsemblePredictor", "logit"),
            ("calibrated isotonic", iso.predict_proba, "MeanEnsemblePredictor", "logit"),
            ("stacking", stack.predict_proba, "StackingPredictor", "logit"),
            ("AdaBoost SAMME", ada.predict_proba, "AdaBoostPredictor", "logit"),
            ("transformed target", ttr.predict, "AffineOutputPredictor", "identity"),
            ("GaussianNB", nb.predict_proba, "QuadraticDiscriminantPredictor", "logit"),
            ("QDA", qda.predict_proba, "QuadraticDiscriminantPredictor", "logit")]


def family_phase(tables, X_all, bg, device, card, seed):
    """Phase 32: the other families at ``B_FAMILY``, each explained once
    through the public entry point: the lifted class, predictions on 256
    rows against the stand-in's numpy within ``ZOO_PRED_REL · max(1,
    |f|)``, the route taken, additivity and the wall."""

    import torch

    X = X_all[:B_FAMILY]
    for name, method, want, link in family_models(tables, X_all, device, seed):
        from distributedkernelshap_tpu_torch import KernelShap

        task = "regression" if link == "identity" else "classification"
        t0 = time.perf_counter()
        explainer = KernelShap(method, link=link, task=task, seed=0, device=device)
        explainer.fit(bg, group_names=ADULT_GROUP_NAMES, groups=adult_groups())
        reset_launches()
        t1 = time.perf_counter()
        expl = explainer.explain(X, silent=True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = kernel_launches()
        lifted = explainer._explainer.predictor
        K = lifted.n_outputs
        _, add_err = sampled_phi(expl, B_FAMILY, K=K)
        rows = X_all[:B_ZOO]
        with torch.no_grad():
            got = lifted(torch.as_tensor(rows, device=device)).cpu().numpy()
        ref = np.asarray(method(rows.astype(np.float64)))
        ref = ref[:, None] if ref.ndim == 1 else ref
        d_pred = float(np.abs(got - ref).max())
        tol = ZOO_PRED_REL * max(1.0, float(np.abs(ref).max()))
        print(f"family {name}: lifted to {type(lifted).__name__} (want {want}), |f lifted - f "
              f"numpy| on {B_ZOO} rows {d_pred:.3e} (tol {tol:.1e}); B={B_FAMILY} link {link} "
              f"route {explainer.kernel_path}, launches {launches}, additivity {add_err:.3e}; "
              f"explain wall {1e3 * (t2 - t1):.1f} ms (fit with lift and probe "
              f"{1e3 * (t1 - t0):.1f} ms) on {card}", flush=True)
        if type(lifted).__name__ != want or not d_pred <= tol or any(launches.values()):
            raise AssertionError(f"the {name} lift or explain is off")


def load_compose_fixture():
    import os

    return np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), COMPOSE_FIXTURE),
                   allow_pickle=False)


def compose_fixture_models(fx):
    """The fixture's models rebuilt as stand-ins from their fitted
    attributes: ``{name: (method, link, lifted class)}``."""

    pipe = Pipeline([("sc", StandardScaler(fx["pipe_mean"], fx["pipe_scale"])),
                     ("lr", LogisticRegression(fx["pipe_coef"], fx["pipe_intercept"]))])
    svc = SVC(fx["svc_sv"], fx["svc_dual"], fx["svc_intercept"], float(fx["svc_gamma"]))
    ends = np.cumsum(fx["cal_len"])
    folds = [(LinearSVC(fx["cal_coef"][i], fx["cal_intercept"][i]),
              IsotonicRegression(fx["cal_x"][e - n:e], fx["cal_y"][e - n:e]))
             for i, (e, n) in enumerate(zip(ends, fx["cal_len"]))]
    cal = CalibratedClassifierCV(folds)
    nb = GaussianNB(fx["nb_theta"], fx["nb_var"], fx["nb_prior"])
    return {"pipe": (pipe.predict_proba, "logit"), "svc": (svc.decision_function, "identity"),
            "cal": (cal.predict_proba, "identity"), "nb": (nb.predict_proba, "identity")}


def compose_fixture_checks(fx, device, n_rows=None):
    """Each fixture model rebuilt, lifted through ``KernelShap`` on
    ``device`` and explained on the fixture's first ``n_rows`` rows (all by
    default): the stand-in's numpy against scikit-learn's outputs, the lifted
    predictions against them within ``ZOO_PRED_REL · max(1, |f|)``, phi
    against the JAX package's within ``PHI_ATOL`` (plus ``LOGIT_ULPS`` f32
    ulps of p through the logit link).  Returns a report per model."""

    import torch
    from distributedkernelshap_tpu_torch import KernelShap

    widths = [int(w) for w in fx["group_widths"]]
    starts = np.concatenate([[0], np.cumsum(widths)[:-1]])
    groups = [list(range(s, s + w)) for s, w in zip(starts, widths)]
    names = [f"g{i}" for i in range(len(widths))]
    X, bg = fx["X"], fx["background"]
    n = n_rows or X.shape[0]
    reports = {}
    for name, (method, link) in compose_fixture_models(fx).items():
        sk = np.asarray(fx[f"{name}_out"], np.float64)
        numpy_err = float(np.abs(np.asarray(method(X.astype(np.float64))) - sk).max())
        t0 = time.perf_counter()
        explainer = KernelShap(method, link=link, seed=0, device=device)
        explainer.fit(bg, group_names=names, groups=groups)
        expl = explainer.explain(X[:n], silent=True)
        if device != "cpu":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        lifted = explainer._explainer.predictor
        with torch.no_grad():
            got = lifted(torch.as_tensor(X, device=device)).cpu().numpy()
        got = got[:, 0] if sk.ndim == 1 else got
        pred_err = float(np.abs(got - sk).max())
        sv = expl.shap_values
        phi = np.stack(sv if isinstance(sv, list) else [sv], 1)
        d_phi = np.abs(phi - fx[f"{name}_phi"][:n]).max((1, 2))
        raw = fx[f"{name}_raw"][:n]
        tol = logit_tol(raw.reshape(n, -1)[:, -1]) if link == "logit" else PHI_ATOL
        reports[name] = {
            "lifted": type(lifted).__name__, "want_class": str(fx[f"{name}_lifted"]),
            "numpy_err": numpy_err, "pred_err": pred_err,
            "pred_ok": pred_err <= ZOO_PRED_REL * max(1.0, float(np.abs(sk).max())),
            "phi_err": float(d_phi.max()), "phi_ok": bool((d_phi <= tol).all()),
            "route": explainer.kernel_path, "seconds": secs, "link": link}
    return reports


def compose_fixture_phase(device, card):
    """Phase 33: ``tests/fixtures/compose_parity.npz`` (made by
    ``scripts/make_compose_parity_fixture.py`` with scikit-learn and the JAX
    package): a Pipeline(StandardScaler, LR), an rbf SVC fitted on 1000
    Adult-schema rows, a calibrated isotonic LinearSVC and a GaussianNB,
    rebuilt from their fitted attributes and explained on the card; their
    predictions against scikit-learn's outputs and their phi against the
    JAX package's."""

    fx = load_compose_fixture()
    reports = compose_fixture_checks(fx, device)
    for name, r in reports.items():
        print(f"compose fixture {name} ({COMPOSE_FIXTURE}, provenance {fx['provenance']}): "
              f"lifted to {r['lifted']} (JAX: {r['want_class']}); stand-in numpy vs "
              f"scikit-learn {r['numpy_err']:.3e}; lifted vs scikit-learn {r['pred_err']:.3e} "
              f"(ok {r['pred_ok']}); link {r['link']} route {r['route']}; |phi card - phi JAX| "
              f"{r['phi_err']:.3e} (ok {r['phi_ok']}); fit + explain B={fx['X'].shape[0]} "
              f"{1e3 * r['seconds']:.1f} ms on {card}", flush=True)
        if not (r["lifted"] == r["want_class"] and r["pred_ok"] and r["phi_ok"]
                and r["numpy_err"] <= 1e-9 * max(1.0, np.abs(fx[f"{name}_out"]).max())):
            raise AssertionError(f"the compose fixture's {name} disagrees")


# ---------------------------------------------------------------------- #
# the ninth slice (phases 34-38): the graph lift, DeepSHAP, the MNIST CNN
# and superpixel image explanations.  The images are MNIST-shaped synthetic
# digits made from --seed by a copy of scripts/process_mnist_data.py's
# generator (that script imports the JAX package); the CNN's parameters are
# the JAX package's trained ones from tests/fixtures/deepshap_parity.npz.


def mnist_templates(rng):
    """Ten smooth 28×28 class templates (low-frequency blobs), as
    ``scripts/process_mnist_data._class_templates`` makes them."""

    H = W = MNIST_SIDE
    yy, xx = np.mgrid[0:H, 0:W]
    templates = np.zeros((MNIST_CLASSES, H, W), dtype=np.float32)
    for c in range(MNIST_CLASSES):
        for _ in range(4):
            cy, cx = rng.uniform(6, 22, 2)
            sy, sx = rng.uniform(2.0, 5.0, 2)
            amp = rng.uniform(0.6, 1.0)
            templates[c] += amp * np.exp(-(((yy - cy) / sy) ** 2 + ((xx - cx) / sx) ** 2))
        templates[c] /= templates[c].max()
    return templates


def synthetic_digits(n, rng, templates, with_labels=False):
    """Shifted, scaled, noisy instances of their class template, in [0, 1]
    (``scripts/process_mnist_data._synthetic_digits``); ``(n, 784)``, with
    their class labels as a second value when ``with_labels``."""

    H = W = MNIST_SIDE
    labels = rng.integers(0, MNIST_CLASSES, size=n)
    images = np.empty((n, H, W), dtype=np.float32)
    shifts = rng.integers(-2, 3, size=(n, 2))
    scales = rng.uniform(0.8, 1.2, size=n)
    noise = rng.normal(0, 0.08, size=(n, H, W)).astype(np.float32)
    for i in range(n):
        t = np.roll(templates[labels[i]], tuple(shifts[i]), axis=(0, 1))
        images[i] = np.clip(t * scales[i] + noise[i], 0.0, 1.0)
    if with_labels:
        return images.reshape(n, -1), labels
    return images.reshape(n, -1)


def mnist_task(seed):
    """``(X, train)``: ``B_MNIST_BIG`` images to explain and
    ``N_MNIST_TRAIN`` training images (their mean is the background, their
    first rows the sampled background), made from ``seed``."""

    rng = np.random.default_rng([seed, 37])
    templates = mnist_templates(rng)
    return (synthetic_digits(B_MNIST_BIG, rng, templates),
            synthetic_digits(N_MNIST_TRAIN, rng, templates))


def graph_op_cases(rng):
    """``[(label, GraphSpec, X)]``: each of the 15 graph ops at the cases of
    ``tests/test_onnx_lift.py`` (Gemm alpha/beta/transB, conv strides, pads
    and bias, grouped and dilated conv, both pools, BN, Transpose, Reshape
    and Flatten), image ops behind a leading Reshape to NCHW."""

    from distributedkernelshap_tpu_torch.registry.onnx_lift import GraphSpec, NodeSpec

    f32 = np.float32

    def graph(nodes, inits, d, out):
        return GraphSpec(nodes, inits, "X", out, d)

    def img(nodes, inits, side, out, channels=1):
        inits = dict(inits)
        inits["shape_img"] = np.asarray([0, channels, side, side], np.int64)
        return GraphSpec([NodeSpec("Reshape", ("X", "shape_img"), ("img",), {})] + nodes,
                         inits, "X", out, channels * side * side)

    def flat(t):
        return NodeSpec("Flatten", (t,), ("y",), {"axis": 1})

    def rows(d, n=5):
        return rng.normal(size=(n, d)).astype(f32)

    unary = [(op, graph([NodeSpec(op, ("X",), ("y",), {"axis": -1} if op == "Softmax"
                                  else {})], {}, 4, "y"), rows(4))
             for op in ("Relu", "Sigmoid", "Tanh", "Softmax", "Identity")]
    return unary + [
        ("MatMul", graph([NodeSpec("MatMul", ("X", "W"), ("y",), {})],
                         {"W": rng.normal(size=(4, 3)).astype(f32)}, 4, "y"), rows(4)),
        ("Gemm alpha/beta/transB",
         graph([NodeSpec("Gemm", ("X", "A", "c"), ("y",),
                         {"alpha": 0.5, "beta": 2.0, "transB": 1})],
               {"A": rng.normal(size=(3, 4)).astype(f32),
                "c": rng.normal(size=(3,)).astype(f32)}, 4, "y"), rows(4)),
        ("Add", graph([NodeSpec("Add", ("X", "c"), ("y",), {})],
                      {"c": rng.normal(size=(4,)).astype(f32)}, 4, "y"), rows(4)),
        ("Reshape+Flatten",
         graph([NodeSpec("Reshape", ("X", "shape"), ("r",), {}), flat("r")],
               {"shape": np.asarray([0, 2, 2], np.int64)}, 4, "y"), rows(4)),
        ("Conv strides/pads/bias",
         img([NodeSpec("Conv", ("img", "Wc", "bc"), ("c",),
                       {"strides": [2, 2], "pads": [0, 0, 1, 1]}), flat("c")],
             {"Wc": rng.normal(size=(2, 1, 3, 3)).astype(f32),
              "bc": rng.normal(size=(2,)).astype(f32)}, 5, "y"), rows(25, 3)),
        ("Conv grouped/dilated",
         img([NodeSpec("Conv", ("img", "Wc"), ("c",),
                       {"strides": [1, 1], "pads": [1, 0, 0, 1], "dilations": [2, 2],
                        "group": 2}), flat("c")],
             {"Wc": rng.normal(size=(4, 1, 2, 2)).astype(f32)}, 6, "y", 2), rows(72, 2)),
        ("MaxPool", img([NodeSpec("MaxPool", ("img",), ("p",),
                                  {"kernel_shape": [2, 2], "strides": [2, 2]}), flat("p")],
                        {}, 5, "y"), rows(25, 3)),
        ("AveragePool", img([NodeSpec("AveragePool", ("img",), ("p",),
                                      {"kernel_shape": [2, 2], "strides": [2, 2]}),
                             flat("p")], {}, 5, "y"), rows(25, 3)),
        ("BatchNormalization",
         img([NodeSpec("BatchNormalization", ("img", "scale", "bias", "mean", "var"),
                       ("n",), {"epsilon": 1e-3}), flat("n")],
             {"scale": rng.uniform(0.5, 1.5, 2).astype(f32),
              "bias": rng.normal(size=(2,)).astype(f32),
              "mean": rng.normal(size=(2,)).astype(f32),
              "var": rng.uniform(0.5, 1.5, 2).astype(f32)}, 3, "y", 2), rows(18, 2)),
        ("Transpose", img([NodeSpec("Transpose", ("img",), ("t",), {"perm": [0, 2, 3, 1]}),
                           flat("t")], {}, 3, "y", 2), rows(18, 2)),
    ]


def graph_rel_err(got, ref) -> float:
    """``max |got - ref| / max(1, |ref|)``, elementwise."""

    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if got.shape != ref.shape:
        return np.inf
    return float((np.abs(got - ref) / np.maximum(1.0, np.abs(ref))).max())


@contextlib.contextmanager
def conv_tf32_probe():
    """Record, at every ``F.conv2d`` call inside the block, whether cuDNN
    may round float32 to TF32 (``utils.cudnn_tf32_enabled``)."""

    import torch.nn.functional as F
    from distributedkernelshap_tpu_torch.utils import cudnn_tf32_enabled

    seen, real = [], F.conv2d

    def probed(*args, **kwargs):
        seen.append(cudnn_tf32_enabled())
        return real(*args, **kwargs)

    F.conv2d = probed
    try:
        yield seen
    finally:
        F.conv2d = real


def graph_ops_phase(device, card, seed):
    """Phase 34: each of the 15 graph ops evaluated by the port's torch
    evaluation on the card against the numpy reference and the port's CPU
    evaluation (``GRAPH_REL`` × max(1, |y|)), with cuDNN TF32 asserted off at
    every convolution inside the span, and at every convolution of a
    DeepSHAP explain of a conv net."""

    import torch
    from distributedkernelshap_tpu_torch.registry.onnx_lift import (
        run_graph_reference,
        run_graph_torch,
    )
    from distributedkernelshap_tpu_torch.utils import cudnn_tf32_enabled

    cases = graph_op_cases(np.random.default_rng([seed, 34]))
    ops, worst = set(), 0.0
    with conv_tf32_probe() as seen:
        for label, spec, X in cases:
            ref = run_graph_reference(spec, X)
            cpu = run_graph_torch(spec, torch.as_tensor(X)).numpy()
            card_y = run_graph_torch(spec, torch.as_tensor(X, device=device)).cpu().numpy()
            e_ref, e_cpu = graph_rel_err(card_y, ref), graph_rel_err(card_y, cpu)
            worst = max(worst, e_ref, e_cpu)
            ops.update(n.op for n in spec.nodes)
            if not (e_ref <= GRAPH_REL and e_cpu <= GRAPH_REL):
                raise AssertionError(f"graph op {label}: card vs numpy {e_ref:.3e}, "
                                     f"vs CPU {e_cpu:.3e} (tol {GRAPH_REL:g})")
        n_graph = len(seen)
        rng = np.random.default_rng([seed, 34])
        fit_graph(stable_cnn_spec(6, seed=1), rng.uniform(0, 1, (2, 36)).astype(np.float32),
                  device).explain(rng.uniform(0, 1, (2, 36)).astype(np.float32),
                                  nsamples="exact", silent=True)
    n_conv = len(seen)
    print(f"graph ops: {len(cases)} cases over {len(ops)} ops on the card, max |card - "
          f"numpy| and |card - CPU| / max(1, |y|) = {worst:.3e} (tol {GRAPH_REL:g}); "
          f"{n_conv} convolutions ({n_graph} graph evaluations, the rest a DeepSHAP "
          f"explain), TF32 on at {sum(seen)} of them; cuDNN TF32 outside the "
          f"span {cudnn_tf32_enabled()} on {card}", flush=True)
    if len(ops) != 15 or n_graph < 4 or n_conv <= n_graph or any(seen):
        raise AssertionError("the graph ops phase missed an op or ran a convolution in TF32")


def logreg_graph(est):
    """The headline logistic regression as an ONNX Gemm+Sigmoid export."""

    from distributedkernelshap_tpu_torch.registry.onnx_lift import GraphSpec, NodeSpec

    coef = np.asarray(est.coef_, np.float32)
    return GraphSpec([NodeSpec("Gemm", ("X", "W", "b"), ("z",), {}, "gemm"),
                      NodeSpec("Sigmoid", ("z",), ("y",), {}, "sigmoid")],
                     {"W": np.ascontiguousarray(coef.T),
                      "b": np.asarray(est.intercept_, np.float32)},
                     "X", "y", coef.shape[1])


def onnx_linear_phase(X, bg, est, device, card, phi_headline):
    """Phase 35: the headline logistic regression as an ONNX Gemm+Sigmoid
    export lowers to a ``LinearPredictor`` (a 2-column softmax); its
    explain at B = 2560, counted, launches ``fused_linear_ey`` exactly once
    on the kernel path ``'cuda'``, and its phi is within ``ONNX_PHI_ATOL``
    of the headline explain of the same model (phase 4)."""

    import torch
    from distributedkernelshap_tpu_torch import KernelShap
    from distributedkernelshap_tpu_torch.models import LinearPredictor
    from distributedkernelshap_tpu_torch.registry import lift_graph

    lifted = lift_graph(logreg_graph(est), device)
    explainer = KernelShap(lifted, link="logit", seed=0, device=device)
    explainer.fit(bg, group_names=ADULT_GROUP_NAMES, groups=adult_groups())
    reset_launches()
    expl = explainer.explain(X, silent=True)
    torch.cuda.synchronize()
    launches, path = kernel_launches(), explainer.kernel_path
    phi, add_err = sampled_phi(expl, X.shape[0])
    d_phi = float(np.abs(phi - phi_headline).max())
    wall, runs = median_wall_ms(lambda: explainer.explain(X, silent=True), 3)
    print(f"onnx lift: Gemm+Sigmoid export of the headline LR lowered to "
          f"{type(lifted).__name__} ({getattr(lifted, 'activation', None)}, K="
          f"{lifted.n_outputs}); explain B={X.shape[0]} launches {launches} (want "
          f"fused_linear_ey=1), kernel_path {path}, additivity {add_err:.3e}; |phi - phi "
          f"headline| {d_phi:.3e} (tol {ONNX_PHI_ATOL:g}); wall median of 3 {wall:.3f} ms "
          f"(runs {runs}) on {card}", flush=True)
    if not (isinstance(lifted, LinearPredictor) and lifted.activation == "softmax"
            and launches == {"fused_linear_ey": 1, "exact_tree_phi": 0, "exact_tree_inter": 0}
            and path == {"ey": "cuda"} and d_phi <= ONNX_PHI_ATOL):
        raise AssertionError("the ONNX linear lowering missed fused_linear_ey or disagrees")
    return launches["fused_linear_ey"]


def stable_cnn_spec(side, seed=0, K=3, channels_out=(4,), nonneg=True,
                    batchnorm=False, maxpool=False):
    """Conv/Relu(+BN/MaxPool)/Dense graph over ``side×side`` pixels, as
    ``benchmarks/deepshap_bench.build_stable_cnn_spec`` builds it:
    ``nonneg=True`` keeps every pre-activation non-negative over
    non-negative pixels (coalition-stable, so DeepSHAP is exact)."""

    from distributedkernelshap_tpu_torch.registry.onnx_lift import GraphSpec, NodeSpec

    rng = np.random.default_rng(seed)

    def maybe(a):
        return np.abs(a) if nonneg else a

    inits = {"shape_img": np.asarray([0, side, side, 1], np.int64)}
    nodes = [NodeSpec("Reshape", ("x", "shape_img"), ("img",), {}),
             NodeSpec("Transpose", ("img",), ("t0",), {"perm": [0, 3, 1, 2]})]
    tensor, c_in, feat = "t0", 1, side
    for i, c_out in enumerate(channels_out):
        inits[f"W{i}"] = maybe(rng.normal(scale=0.4, size=(c_out, c_in, 3, 3))).astype(np.float32)
        inits[f"b{i}"] = maybe(rng.normal(scale=0.1, size=c_out)).astype(np.float32)
        nodes.append(NodeSpec("Conv", (tensor, f"W{i}", f"b{i}"), (f"c{i}",),
                              {"strides": [2, 2], "pads": [1, 1, 1, 1]}, f"conv{i}"))
        tensor, c_in, feat = f"c{i}", c_out, -(-feat // 2)
        if batchnorm:
            inits.update({f"s{i}": rng.uniform(0.5, 1.5, c_out).astype(np.float32),
                          f"o{i}": rng.normal(scale=0.1, size=c_out).astype(np.float32),
                          f"m{i}": rng.normal(scale=0.1, size=c_out).astype(np.float32),
                          f"v{i}": rng.uniform(0.5, 1.5, c_out).astype(np.float32)})
            nodes.append(NodeSpec("BatchNormalization",
                                  (tensor, f"s{i}", f"o{i}", f"m{i}", f"v{i}"),
                                  (f"n{i}",), {"epsilon": 1e-5}))
            tensor = f"n{i}"
        nodes.append(NodeSpec("Relu", (tensor,), (f"r{i}",), {}))
        tensor = f"r{i}"
    if maxpool:
        nodes.append(NodeSpec("MaxPool", (tensor,), ("mp",),
                              {"kernel_shape": [2, 2], "strides": [2, 2]}))
        tensor, feat = "mp", feat // 2
    nodes.append(NodeSpec("Flatten", (tensor,), ("fl",), {"axis": 1}))
    inits["Wd"] = rng.normal(scale=0.3, size=(c_in * feat * feat, K)).astype(np.float32)
    inits["bd"] = rng.normal(scale=0.1, size=K).astype(np.float32)
    nodes.append(NodeSpec("Gemm", ("fl", "Wd", "bd"), ("y",), {}))
    return GraphSpec(nodes, inits, "x", "y", side * side)


def additive_mlp_spec(seed=0, M=12, H=24, K=2):
    """Feature-wise Relu MLP (each hidden unit reads one feature),
    mixed-sign (``benchmarks/deepshap_bench.build_additive_mlp_spec``):
    additive, so DeepSHAP is exact while the Relus clip."""

    from distributedkernelshap_tpu_torch.registry.onnx_lift import GraphSpec, NodeSpec

    rng = np.random.default_rng(seed)
    W1 = np.zeros((M, H), np.float32)
    for j in range(H):
        W1[j % M, j] = rng.normal()
    return GraphSpec(
        [NodeSpec("Gemm", ("x", "W1", "b1"), ("h",), {}),
         NodeSpec("Relu", ("h",), ("a",), {}),
         NodeSpec("Gemm", ("a", "W2", "b2"), ("y",), {})],
        {"W1": W1, "b1": rng.normal(size=H).astype(np.float32),
         "W2": rng.normal(scale=0.5, size=(H, K)).astype(np.float32),
         "b2": rng.normal(size=K).astype(np.float32)},
        "x", "y", M)


def fit_graph(spec, bg, device, groups=None):
    """``KernelShap(lift_graph(spec)).fit(bg, groups)`` on ``device``."""

    from distributedkernelshap_tpu_torch import KernelShap
    from distributedkernelshap_tpu_torch.registry import lift_graph

    explainer = KernelShap(lift_graph(spec, device), seed=0, device=device)
    return explainer.fit(bg, groups=groups,
                         group_names=None if groups is None else [f"g{i}" for i in
                                                                  range(len(groups))])


def deep_phi(expl, B, K, M):
    phi = np.stack(expl.shap_values, 1)
    if phi.shape != (B, K, M) or not np.isfinite(phi).all():
        raise AssertionError(f"bad DeepSHAP values: shape {phi.shape}, "
                             f"finite={np.isfinite(phi).all()}")
    return phi


def completeness(expl) -> float:
    """``max |Σφ + E - f(x)| / max(1, max|f(x)|)`` of an identity-link
    explanation."""

    phi = np.stack(expl.shap_values, 1)
    raw = np.asarray(expl.data["raw"]["raw_prediction"], np.float64)
    err = np.abs(phi.sum(2) + np.asarray(expl.expected_value)[None, :] - raw).max()
    return float(err / max(1.0, np.abs(raw).max()))


def deepshap_exact_phase(device, card, seed):
    """Phase 36: exactness on the card, as ``benchmarks/deepshap_bench.py``'s
    phase 1 holds it: the coalition-stable conv net (side 6, M = 9
    superpixels) and the additive MLP against the port's brute-force
    Shapley enumeration within ``EXACT_RTOL`` relative; completeness of a
    mixed-sign BN and a MaxPool CNN within ``EXACT_RTOL`` relative."""

    import torch
    from distributedkernelshap_tpu_torch.attribution import brute_force_shapley
    from distributedkernelshap_tpu_torch.ops.explain import groups_to_matrix
    from distributedkernelshap_tpu_torch.ops.image import superpixel_groups
    from distributedkernelshap_tpu_torch.registry.onnx_lift import run_graph_reference

    rng = np.random.default_rng([seed, 36])
    groups, _ = superpixel_groups(6, 6, patch=2)
    cases = [("stable conv net", stable_cnn_spec(6, seed=1), groups,
              rng.uniform(0, 1, (3, 36)), rng.uniform(0, 1, (2, 36))),
             ("additive MLP", additive_mlp_spec(seed=2), None,
              rng.normal(size=(4, 12)), rng.normal(size=(2, 12)))]
    errs = {}
    for label, spec, grp, bg, X in cases:
        bg, X = bg.astype(np.float32), X.astype(np.float32)
        explainer = fit_graph(spec, bg, device, grp)
        reset_launches()
        expl = explainer.explain(X, nsamples="exact", silent=True)
        torch.cuda.synchronize()
        G = None if grp is None else groups_to_matrix(grp, spec.input_dim)
        phi = deep_phi(expl, X.shape[0], explainer._explainer.predictor.n_outputs,
                       len(grp) if grp else spec.input_dim)
        ref = np.stack([brute_force_shapley(lambda r: run_graph_reference(spec, r), x, bg, G=G)
                        for x in X])
        errs[label] = float(np.abs(phi - ref).max() / max(np.abs(ref).max(), 1e-9))
        if any(kernel_launches().values()) or explainer.kernel_path != {"exact_phi": "deepshap"} \
                or not errs[label] <= EXACT_RTOL:
            raise AssertionError(f"{label}: DeepSHAP vs brute force {errs[label]:.3e} "
                                 f"(tol {EXACT_RTOL:g}), kernel_path {explainer.kernel_path}")
    comp = {}
    for label, spec, d in (("BN CNN", stable_cnn_spec(6, seed=3, nonneg=False, batchnorm=True),
                            36),
                           ("MaxPool CNN", stable_cnn_spec(8, seed=4, nonneg=False,
                                                           maxpool=True), 64)):
        bg = rng.uniform(0, 1, (3, d)).astype(np.float32)
        X = rng.uniform(0, 1, (3, d)).astype(np.float32)
        comp[label] = completeness(fit_graph(spec, bg, device).explain(
            X, nsamples="exact", silent=True))
        if not comp[label] <= EXACT_RTOL:
            raise AssertionError(f"{label}: completeness {comp[label]:.3e}")
    print(f"deepshap exact: relative error against brute force {errs} (tol {EXACT_RTOL:g}, "
          f"the stable net over {len(groups)} superpixels, {2 ** len(groups)} coalitions); "
          f"completeness {comp}; no hand kernel launched, on {card}", flush=True)


def mnist_cnn(fx, output, device):
    """The ``config_mnist`` CNN on ``device`` with the fixture's trained
    flax parameters (``convert.cnn_from_numpy``)."""

    from distributedkernelshap_tpu_torch.convert import cnn_from_numpy

    params = {}
    for key in fx.files:
        if key.startswith("param/"):
            _, layer, leaf = key.split("/")
            params.setdefault(layer, {})[leaf] = fx[key]
    return cnn_from_numpy(params, (MNIST_SIDE, MNIST_SIDE, 1), MNIST_CLASSES, output, device)


def load_deepshap_fixture():
    import os

    return np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                DEEPSHAP_FIXTURE), allow_pickle=False)


def mnist_explainer(fx, bg, device, output="logits", link="identity", engine_config=None):
    """``KernelShap(cnn, link).fit(bg, groups=superpixels)`` over the 49
    superpixels of 4×4 (``configs.py:420``)."""

    from distributedkernelshap_tpu_torch import EngineConfig, KernelShap
    from distributedkernelshap_tpu_torch.ops.image import superpixel_groups

    groups, names = superpixel_groups(MNIST_SIDE, MNIST_SIDE, MNIST_PATCH)
    explainer = KernelShap(mnist_cnn(fx, output, device), link=link, feature_names=names,
                           seed=0, device=device,
                           engine_config=engine_config or EngineConfig())
    return explainer.fit(bg, group_names=names, groups=groups)


def mnist_fixture_checks(fx, device, n_rows=None, heads=("deep", "sampled")):
    """The fixture's CNN rebuilt on ``device`` and its first ``n_rows``
    images (all by default) explained against the mean background: the
    logits head under ``nsamples='exact'`` (DeepSHAP, ``'deep'``) against
    the JAX phi within ``DEEP_REL`` × max(1, max|φ|), E and f(x) within 1e-5
    × max(1, max|φ|); the probs head sampled with ``link='logit'``,
    ``l1_reg=False`` (``'sampled'``) against the JAX phi within
    ``PHI_ATOL`` plus ``LOGIT_ULPS`` f32 ulps of p per (row, class).
    Returns a report per head of ``heads``."""

    import torch

    X, bg = fx["X"], fx["bg"]
    n = n_rows or X.shape[0]
    reports = {}
    if "deep" in heads:
        reports["deep"] = _mnist_deep_report(fx, X[:n], bg, device)
    if "sampled" in heads:
        reports["sampled"] = _mnist_sampled_report(fx, X[:n], bg, device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return reports


def _mnist_deep_report(fx, X, bg, device):
    n = X.shape[0]
    deep = mnist_explainer(fx, bg, device)
    e_deep = deep.explain(X, nsamples="exact", silent=True)
    phi = deep_phi(e_deep, n, MNIST_CLASSES, len(deep.feature_names))
    ref = fx["deep_phi"][:n]
    scale = max(1.0, float(np.abs(ref).max()))
    raw = np.asarray(e_deep.data["raw"]["raw_prediction"])
    e_val = np.asarray(e_deep.expected_value)
    r = {"phi_err": float(np.abs(phi - ref).max()), "tol": DEEP_REL * scale,
         "fx_err": float(np.abs(raw - fx["deep_raw"][:n]).max()),
         "e_err": float(np.abs(e_val - fx["deep_expected"]).max()),
         "completeness": completeness(e_deep), "route": deep.kernel_path}
    r["ok"] = bool(r["phi_err"] <= r["tol"] and r["fx_err"] <= 1e-5 * scale
                   and r["e_err"] <= 1e-5 * scale and r["completeness"] <= EXACT_RTOL
                   and r["route"] == {"exact_phi": "deepshap"})
    return r


def _mnist_sampled_report(fx, X, bg, device):
    n = X.shape[0]
    sampled = mnist_explainer(fx, bg, device, output="probs", link="logit")
    e_samp = sampled.explain(X, l1_reg=False, silent=True)
    phi = deep_phi(e_samp, n, MNIST_CLASSES, len(sampled.feature_names))
    d = np.abs(phi - fx["sampled_phi"][:n]).max(2)                   # (n, K)
    tol = logit_tol(fx["sampled_raw"][:n])
    add_err = additivity(e_samp)
    return {"phi_err": float(d.max()), "tol_min": float(tol.min()),
            "within_atol": int((d <= PHI_ATOL).sum()), "cells": int(d.size),
            "additivity": add_err, "route": sampled.kernel_path,
            "ok": bool((d <= tol).all() and add_err < ADDITIVITY
                       and sampled.kernel_path == {"ey": "generic"})}


def cnn_forward_flops(side=MNIST_SIDE, K=MNIST_CLASSES) -> int:
    """FLOP of one forward of the ``config_mnist`` CNN (2 per MAC): 355,008
    MACs an image at 28×28, K = 10."""

    h1 = -(-side // 2)
    h2 = -(-h1 // 2)
    macs = h1 * h1 * 16 * 9 + h2 * h2 * 32 * 9 * 16 + h2 * h2 * 32 * 64 + 64 * K
    return 2 * macs


def mnist_deepshap_phase(fx, X, train, device, card):
    """Phase 37: DeepSHAP at the full width of ``config_mnist`` (the CNN's
    logits head, M = 49 superpixels of 4×4): B = 2048 against the mean
    background (N = 1) and against 16 sampled rows (N = 16), B = 10000 with
    ``instance_chunk=2048``; each counted (no hand kernel), complete within
    ``EXACT_RTOL``, timed (median of 3 after one warm-up) with device busy,
    idle share and events under ``torch.profiler`` and the share of its f32
    FLOP bound (``(1 + K)`` forwards per instance and background row); a
    staged explain bit-identical to the synchronous one; the fixture's 32
    images against the JAX phi."""

    import torch
    from distributedkernelshap_tpu_torch import EngineConfig
    from distributedkernelshap_tpu_torch.kernel_shap import StagedRows
    from distributedkernelshap_tpu_torch.ops.image import image_background

    M = (MNIST_SIDE // MNIST_PATCH) ** 2
    runs_out = {}
    for label, bg, B, cfg in (
            ("N=1", image_background(train, mode="mean"), B_MNIST, None),
            (f"N={N_MNIST_SAMPLE}", image_background(train, mode="sample",
                                                     n_rows=N_MNIST_SAMPLE), B_MNIST, None),
            ("N=1 chunked", image_background(train, mode="mean"), B_MNIST_BIG,
             EngineConfig(instance_chunk=MNIST_CHUNK))):
        explainer = mnist_explainer(fx, bg, device, engine_config=cfg)
        reset_launches()
        with conv_tf32_probe() as seen:
            expl = explainer.explain(X[:B], nsamples="exact", silent=True)
            torch.cuda.synchronize()
        launches = kernel_launches()
        deep_phi(expl, B, MNIST_CLASSES, M)
        comp = completeness(expl)
        wall, runs = median_wall_ms(
            lambda: explainer.explain(X[:B], nsamples="exact", silent=True), 3)
        wall_p, busy, idle, n_events, top = device_busy(
            lambda: explainer.explain(X[:B], nsamples="exact", silent=True))
        flops = B * bg.shape[0] * (1 + MNIST_CLASSES) * cnn_forward_flops()
        bound = 1e3 * flops / FP32_FLOPS_PER_S
        print(f"mnist deepshap {label} B={B}: launches {launches} (want all 0), kernel_path "
              f"{explainer.kernel_path}, completeness {comp:.3e} (tol {EXACT_RTOL:g}); "
              f"{len(seen)} convolutions, TF32 on at {sum(seen)}; wall "
              f"median of 3 {wall:.3f} ms (runs {runs}); under torch.profiler wall "
              f"{wall_p:.3f} ms, busy {busy:.3f} ms, idle {idle:.4f}, {n_events} device "
              f"events, top {top}; {flops:.3e} f32 FLOP, bound {bound:.4f} ms, "
              f"{100 * bound / wall:.2f}% of the wall on {card}", flush=True)
        if any(launches.values()) or explainer.kernel_path != {"exact_phi": "deepshap"} \
                or not comp <= EXACT_RTOL or not seen or any(seen):
            raise AssertionError(f"the MNIST DeepSHAP explain ({label}) is off")
        runs_out[label] = wall
        if label == "N=1":
            engine = explainer._explainer
            want = np.stack(engine.get_explanation(X[:B], nsamples="exact"), 1)
            staged = engine.stage_rows(X[:B], nsamples="exact")
            values, _ = engine.get_explanation_async(staged, nsamples="exact")()
            same = bool(np.array_equal(np.stack(values, 1), want))
            on_card = torch.device(device).type == "cuda"
            print(f"mnist deepshap staged B={B}: StagedRows={isinstance(staged, StagedRows)}"
                  f" with event={staged is not None and staged.ready is not None}, "
                  f"bit-identical to sync {same}", flush=True)
            if not (isinstance(staged, StagedRows) and same
                    and (staged.ready is not None or not on_card)):
                raise AssertionError("the staged DeepSHAP explain disagrees with the sync one")
    r = mnist_fixture_checks(fx, device, heads=("deep",))["deep"]
    print(f"mnist deepshap fixture ({DEEPSHAP_FIXTURE}, provenance {fx['provenance']}: "
          f"synthetic digits, not MNIST): {fx['X'].shape[0]} images, |phi card - phi JAX| "
          f"{r['phi_err']:.3e} (tol {DEEP_REL:g} x max(1, max|phi|) = {r['tol']:.3e}), "
          f"|f(x) - f(x) JAX| {r['fx_err']:.3e}, |E - E JAX| {r['e_err']:.3e}, completeness "
          f"{r['completeness']:.3e}, route {r['route']}", flush=True)
    if not r["ok"]:
        raise AssertionError("the MNIST DeepSHAP explain disagrees with the JAX fixture")
    return runs_out


def mnist_sampled_phase(fx, X, train, device, card):
    """Phase 38: ``config_mnist``'s own sampled image KernelSHAP at B =
    2048: the probs head, ``link='logit'``, ``l1_reg=False``, default
    nsamples (S = 2146), through the generic route (recorded), counted (no
    hand kernel); float32 transfer additive (< 1e-3), the benchmark's
    ``EngineConfig(instance_chunk=2048, transfer_dtype='float16')`` within
    the packed tolerance of float32; walls (median of 3 after one warm-up),
    device busy and idle share, against the f32 FLOP bound of B·S·N
    forwards; the fixture's 32 images against the JAX phi."""

    import torch
    from distributedkernelshap_tpu_torch import EngineConfig
    from distributedkernelshap_tpu_torch.ops.explain import ShapConfig
    from distributedkernelshap_tpu_torch.ops.image import image_background

    bg = image_background(train, mode="mean")
    Xb = X[:B_MNIST]
    out = {}
    for label, cfg in (("f32", None),
                       ("f16", EngineConfig(instance_chunk=MNIST_CHUNK,
                                            shap=ShapConfig(transfer_dtype="float16")))):
        explainer = mnist_explainer(fx, bg, device, output="probs", link="logit",
                                    engine_config=cfg)
        reset_launches()
        expl = explainer.explain(Xb, l1_reg=False, silent=True)
        torch.cuda.synchronize()
        launches = kernel_launches()
        phi = deep_phi(expl, B_MNIST, MNIST_CLASSES, len(explainer.feature_names))
        add_err = additivity(expl)
        wall, runs = median_wall_ms(lambda: explainer.explain(Xb, l1_reg=False, silent=True), 3)
        S = explainer._explainer._plan(None).n_rows
        flops = B_MNIST * S * bg.shape[0] * cnn_forward_flops()
        bound = 1e3 * flops / FP32_FLOPS_PER_S
        out[label] = phi
        extra = ""
        if label == "f16":
            d = np.abs(phi - out["f32"])
            ok16 = bool((d <= F16_ATOL + F16_RTOL * np.abs(out["f32"])).all())
            extra = f"; |phi f16 - phi f32| max {d.max():.3e} (within atol {F16_ATOL:g} + " \
                    f"rtol {F16_RTOL:g}: {ok16})"
        else:
            wall_p, busy, idle, n_events, top = device_busy(
                lambda: explainer.explain(Xb, l1_reg=False, silent=True))
            extra = (f"; under torch.profiler wall {wall_p:.3f} ms, busy {busy:.3f} ms, idle "
                     f"{idle:.4f}, {n_events} device events, top {top}")
        print(f"mnist sampled {label} B={B_MNIST} S={S}: launches {launches} (want all 0), "
              f"kernel_path {explainer.kernel_path}, additivity {add_err:.3e}; wall median of "
              f"3 {wall:.3f} ms (runs {runs}); {flops:.3e} f32 FLOP, bound {bound:.4f} ms, "
              f"{100 * bound / wall:.2f}% of the wall{extra} on {card}", flush=True)
        if any(launches.values()) or explainer.kernel_path != {"ey": "generic"} \
                or (label == "f32" and not add_err < ADDITIVITY) \
                or (label == "f16" and not ok16):
            raise AssertionError(f"the MNIST sampled explain ({label}) is off")
    r = mnist_fixture_checks(fx, device, heads=("sampled",))["sampled"]
    print(f"mnist sampled fixture ({DEEPSHAP_FIXTURE}): |phi card - phi JAX| {r['phi_err']:.3e}"
          f" (tol {PHI_ATOL:g} + {LOGIT_ULPS} p-ulps, smallest {r['tol_min']:.3e}; "
          f"{r['within_atol']}/{r['cells']} (row, class) cells within {PHI_ATOL:g} alone), "
          f"additivity {r['additivity']:.3e}, route {r['route']}", flush=True)
    if not r["ok"]:
        raise AssertionError("the MNIST sampled explain disagrees with the JAX fixture")


# ---------------------------------------------------------------------- #
# the twelfth slice (phases 43-45): one process over a mesh of devices,
# train_mnist_cnn


def _mesh_opts(device, n, cp, batch_size):
    """``distributed_opts`` of a mesh layout: ``n`` copies of ``device``
    (``n=None``: ``n_devices`` = every visible card, the default devices)."""

    import torch

    if n is None:
        return {"n_devices": torch.cuda.device_count(), "batch_size": batch_size}
    return {"n_devices": n, "devices": [device] * n, "coalition_parallel": cp,
            "batch_size": batch_size}


def mesh_slabs(dist, B):
    """Slabs a mesh explain of ``B`` rows runs (``DistributedExplainer``'s
    ``batch_size`` rule)."""

    slab = dist._slab_size()
    return -(-B // slab) if slab and B > slab else 1


def mesh_headline_phase(X, bg, est, device, card, expl_headline):
    """Phase 43: the headline task (B = 2560, N = 100, the LR at K = 2,
    ``link='logit'``) on the mesh layouts of ``MESH_LAYOUTS``, each through
    ``KernelShap(..., distributed_opts=...)``: counted, ``fused_linear_ey``
    launched exactly shards × slabs times (a shard's coalition rows go to
    the kernel whole: one chunk), additive, phi within 1e-3 plus 16 p-ulps
    of phase 4's single-device answer (ROADMAP C.9); the kernel against its
    plain version on every shard's own inputs; the wall of each layout
    (its counted run, then one more).  Returns ``(launches, max_abs_err)``."""

    import torch
    from distributedkernelshap_tpu_torch import KernelShap
    from distributedkernelshap_tpu_torch.parallel.distributed import DistributedExplainer

    phi_headline = np.stack(expl_headline.shap_values, 1)
    tol = logit_tol(expl_headline.data["raw"]["raw_prediction"][:, 1])
    total, worst, lines = 0, 0.0, []
    for label, n, cp, batch_size in MESH_LAYOUTS:
        explainer = KernelShap(est.predict_proba, link="logit",
                               feature_names=ADULT_GROUP_NAMES, seed=0, device=device,
                               distributed_opts=_mesh_opts(device, n, cp, batch_size))
        explainer.fit(bg, group_names=ADULT_GROUP_NAMES, groups=adult_groups())
        dist = explainer._explainer
        if not isinstance(dist, DistributedExplainer):
            raise AssertionError(f"{label}: distributed_opts built no DistributedExplainer")
        shards = dist.mesh.size
        want = shards * mesh_slabs(dist, X.shape[0])
        with recorded_ey_calls() as calls:
            reset_launches()
            t0 = time.perf_counter()
            expl = explainer.explain(X, silent=True)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
            launches = kernel_launches()
        phi, add_err = check_explanation(expl, X.shape[0])
        d = np.abs(phi - phi_headline).max((1, 2))
        err = kernel_vs_plain_on(calls)
        worst = max(worst, err)
        t0 = time.perf_counter()
        explainer.explain(X, silent=True)
        torch.cuda.synchronize()
        wall2 = 1e3 * (time.perf_counter() - t0)
        shapes = sorted({(a[0].shape[0], a[4].shape[0]) for a, _ in calls})
        lines.append(f"{label} ({dist.mesh.shape['data']}x{dist.mesh.shape['coalition']}, "
                     f"{shards} shards, {mesh_slabs(dist, X.shape[0])} slabs): launches "
                     f"{launches} (want fused_linear_ey {want}), kernel_path "
                     f"{explainer.kernel_path}, per-launch (B, S) {shapes}; additivity "
                     f"{add_err:.3e}; |phi mesh - phi single| max {d.max():.3e} (rows "
                     f"within 1e-3 + 16 p-ulps {int((d <= tol).sum())}/{X.shape[0]}); "
                     f"kernel vs plain {err:.3e}; wall {wall:.3f} ms counted, "
                     f"{wall2:.3f} ms again")
        print("mesh headline: " + lines[-1], flush=True)
        if launches != {"fused_linear_ey": want, "exact_tree_phi": 0, "exact_tree_inter": 0} \
                or explainer.kernel_path.get("ey") != "cuda" or not (d <= tol).all():
            raise AssertionError(f"the {label} mesh explain missed its launches or "
                                 "disagrees with the single-device one")
        total += launches["fused_linear_ey"]
    print(f"mesh headline on {card}: {total} fused_linear_ey launches over "
          f"{len(MESH_LAYOUTS)} layouts", flush=True)
    return total, worst


@contextlib.contextmanager
def recorded_exact_calls():
    """Inside the block, every ``exact_tree_phi`` / ``exact_tree_inter`` call
    of the exact paths (``ops.treeshap`` imports the wrappers by name)
    appends ``(name, args, kwargs)`` to the yielded list; the kernels still
    launch and count."""

    from distributedkernelshap_tpu_torch.ops import treeshap as treeshap_mod

    calls, real = [], {}
    for name in ("exact_tree_phi", "exact_tree_inter"):
        real[name] = getattr(treeshap_mod, name)

        def recorded(*a, _name=name, **k):
            calls.append((_name, a, k))
            return real[_name](*a, **k)

        setattr(treeshap_mod, name, recorded)
    try:
        yield calls
    finally:
        for name, fn in real.items():
            setattr(treeshap_mod, name, fn)


def exact_vs_plain_on(calls):
    """Each recorded exact-kernel call against its plain version on the
    same inputs (after the path's counts were read): phi within
    ``PHI_REL`` × max(1, max|phi|), the raw pairwise sum within ``RAW_TOL``
    (atol and rtol).  Returns ``{name: worst max abs diff}``."""

    from distributedkernelshap_tpu_torch.ops import cuda_kernels as ck

    worst = {"exact_tree_phi": 0.0, "exact_tree_inter": 0.0}
    for name, a, k in calls:
        got = getattr(ck, name)(*a, **k)
        ref = getattr(ck, f"{name}_plain")(*a, **k)
        if name == "exact_tree_phi":
            err = rel_close(got.cpu().numpy(), ref.cpu().numpy())
        else:
            err, ok = raw_close(got, ref)
            if not ok:
                raise AssertionError(f"exact_tree_inter vs plain {err:.3e} on a mesh shard")
        worst[name] = max(worst[name], err)
    return worst


def fitted_fixture_tree(fx, bg, device, opts=None, pack_paths=None):
    """The fixture GBT (``adult_trees_exact``) fitted on ``bg`` with the
    Adult grouping, on a mesh where ``opts`` (``distributed_opts``) asks
    for one."""

    from distributedkernelshap_tpu_torch import EngineConfig, KernelShap, TreeEnsemblePredictor
    from distributedkernelshap_tpu_torch.ops.explain import ShapConfig

    tree = TreeEnsemblePredictor(
        fx["tree_feature"], fx["tree_threshold"], fx["tree_left"], fx["tree_right"],
        fx["tree_value"], depth=int(fx["tree_depth"]), aggregation="sum",
        base=fx["tree_base"], scale=float(fx["tree_scale"]),
        missing_left=fx["tree_missing_left"], vector_out=False, device=device)
    ex = KernelShap(tree, task="regression", seed=0, device=device, distributed_opts=opts,
                    engine_config=EngineConfig(shap=ShapConfig(pack_paths=pack_paths)))
    return ex.fit(bg, group_names=fx["names"], groups=fx["groups"])


def mesh_exact_phase(device, card, seed):
    """Phase 44: the exact paths on the mesh, the fixture GBT
    (``adult_trees_exact`` of ``tests/fixtures/adult_parity.npz``) on its
    first ``MESH_EXACT_ROWS`` rows: dense with interactions at 1x2 on the
    first ``MESH_BG_ODD`` background rows (``pad_background`` adds one
    zero-weight row; one ``exact_tree_phi`` and one ``exact_tree_inter``
    launch a shard), packed at 1x2 (the plan striped over 2 shards: one
    launch per local bucket and shard), a journaled dense run at 2x1 in
    slabs of ``MESH_JOURNAL_BATCH`` rows a data shard whose replay launches
    nothing and returns the same bits; the reference's mid-size tensor train
    (M = 24, rank 4, N = 32) at 2x1 (no hand kernel).  Each against the
    single-device explain within ``PHI_REL`` × max(1, max|·|), each exact
    launch against its plain version on the shard's inputs.  Returns
    ``({kernel: launches}, {kernel: max_abs_err})``."""

    import tempfile

    import torch
    from distributedkernelshap_tpu_torch import EngineConfig, KernelShap
    from distributedkernelshap_tpu_torch.models.tensor_net import TensorTrainPredictor
    from distributedkernelshap_tpu_torch.ops.explain import ShapConfig
    from distributedkernelshap_tpu_torch.ops.treeshap import build_packed_plan

    fx = adult_fixture()
    X = fx["X"][:MESH_EXACT_ROWS]
    B = X.shape[0]

    def fitted(bg, opts=None, pack_paths=None, pred=None, groups=True):
        if pred is None:
            return fitted_fixture_tree(fx, bg, device, opts, pack_paths)
        ex = KernelShap(pred, task="regression", seed=0, device=device,
                        distributed_opts=opts,
                        engine_config=EngineConfig(shap=ShapConfig(pack_paths=pack_paths)))
        if groups:
            return ex.fit(bg, group_names=fx["names"], groups=fx["groups"])
        return ex.fit(bg)

    def run(ex, rows, inter=False):
        with recorded_exact_calls() as calls:
            reset_launches()
            t0 = time.perf_counter()
            expl = ex.explain(rows, nsamples="exact", interactions=inter, silent=True)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
            launches = kernel_launches()
        return expl, launches, calls, wall

    total = {"exact_tree_phi": 0, "exact_tree_inter": 0}
    worst = {"exact_tree_phi": 0.0, "exact_tree_inter": 0.0}

    def account(label, launches, want, calls):
        errs = exact_vs_plain_on(calls)
        for k in worst:
            worst[k] = max(worst[k], errs[k])
            total[k] += launches[k]
        if launches != {"fused_linear_ey": 0, **want}:
            raise AssertionError(f"mesh {label}: launches {launches}, want {want}")
        return errs

    # dense with interactions at 1x2, the background padded by one row
    bg_odd = fx["background"][:MESH_BG_ODD]
    single = fitted(bg_odd).explain(X, nsamples="exact", interactions=True, silent=True)
    phi_1 = exact_phi(single, B)[0]
    inter_1 = interaction_values(single, B)[0]
    ex = fitted(bg_odd, _mesh_opts(device, 2, 2, None))
    expl, launches, calls, wall = run(ex, X, inter=True)
    phi, inter = exact_phi(expl, B)[0], interaction_values(expl, B)[0]
    d_phi, d_inter = rel_close(phi, phi_1), rel_close(inter, inter_1)
    errs = account("dense interactions", launches,
                   {"exact_tree_phi": 2, "exact_tree_inter": 2}, calls)
    n_loc = {a[2].shape[0] for name, a, _ in calls}
    print(f"mesh exact dense+interactions 1x2, N={MESH_BG_ODD} (background rows a shard "
          f"{sorted(n_loc)}: one zero-weight pad row): launches {launches}, kernel_path "
          f"{ex.kernel_path}; |phi - single|={d_phi:.3e}, |interactions - single|="
          f"{d_inter:.3e} (tol {PHI_REL:g} x max(1, max|.|)); kernels vs plain {errs}; "
          f"wall {wall:.3f} ms", flush=True)

    # packed at 1x2: the plan's buckets striped over the coalition axis
    bg = fx["background"]
    single = fitted(bg, pack_paths=True).explain(X, nsamples="exact", silent=True)
    phi_1 = exact_phi(single, B)[0]
    ex = fitted(bg, _mesh_opts(device, 2, 2, None), pack_paths=True)
    plan = build_packed_plan(ex._explainer.engine.predictor, ex._explainer.engine.G,
                             shards=2)
    expl, launches, calls, wall = run(ex, X)
    d_phi = rel_close(exact_phi(expl, B)[0], phi_1)
    errs = account("packed", launches, {"exact_tree_phi": 2 * len(plan.buckets),
                                        "exact_tree_inter": 0}, calls)
    print(f"mesh exact packed 1x2: plan with shards=2 has {len(plan.buckets)} buckets "
          f"{list(plan.buckets)} ({plan.local_len} paths a shard); launches {launches} "
          f"(want 2 x {len(plan.buckets)}); |phi - single|={d_phi:.3e}; kernel vs plain "
          f"{errs['exact_tree_phi']:.3e}; wall {wall:.3f} ms", flush=True)

    # a journaled dense run at 2x1 in slabs; the replay launches nothing
    single = fitted(bg, pack_paths=False).explain(X, nsamples="exact", silent=True)
    phi_1 = exact_phi(single, B)[0]
    with tempfile.TemporaryDirectory() as tmp:
        opts = {**_mesh_opts(device, 2, 1, MESH_JOURNAL_BATCH), "checkpoint_dir": tmp}
        ex = fitted(bg, opts, pack_paths=False)
        slabs = mesh_slabs(ex._explainer, B)
        expl, launches, calls, wall = run(ex, X)
        stats = dict(ex._explainer.last_journal_stats)
        phi = exact_phi(expl, B)[0]
        d_phi = rel_close(phi, phi_1)
        errs = account("journaled", launches, {"exact_tree_phi": 2 * slabs,
                                               "exact_tree_inter": 0}, calls)
        replay = fitted(bg, opts, pack_paths=False)
        expl2, launches2, _, wall2 = run(replay, X)
        stats2 = dict(replay._explainer.last_journal_stats)
    same = np.array_equal(np.asarray(expl2.shap_values[0]), phi)
    print(f"mesh exact journaled 2x1 in {slabs} slabs: launches {launches} (want 2 x "
          f"{slabs}), journal {stats}; replay launches {launches2}, journal {stats2}, "
          f"bit-identical {same}; |phi - single|={d_phi:.3e}; walls {wall:.3f} ms, replay "
          f"{wall2:.3f} ms", flush=True)
    if sum(launches2.values()) != 0 or not same or stats2.get("computed") != 0 \
            or stats2.get("restored") != slabs:
        raise AssertionError("the journaled mesh replay recomputed or changed its answer")

    # the tensor train at 2x1
    M, rank, N = TN_MID
    rng = np.random.default_rng([seed, 44])
    cores = tt_cores(M, rank, seed)
    bg_tn = rng.normal(size=(N, M)).astype(np.float32)
    X_tn = rng.normal(size=(B, M)).astype(np.float32)
    single = fitted(bg_tn, pred=TensorTrainPredictor(cores, device=device), groups=False)
    expl_1 = single.explain(X_tn, nsamples="exact", silent=True)
    ex = fitted(bg_tn, _mesh_opts(device, 2, 1, None),
                pred=TensorTrainPredictor(cores, device=device), groups=False)
    reset_launches()
    t0 = time.perf_counter()
    expl = ex.explain(X_tn, nsamples="exact", silent=True)
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    launches = kernel_launches()
    d_phi = rel_close(np.asarray(expl.shap_values[0]), np.asarray(expl_1.shap_values[0]))
    add_err = additivity(expl)
    print(f"mesh exact tensor train 2x1 (M={M}, rank {rank}, N={N}, B={B}): launches "
          f"{launches} (no hand kernel), kernel_path {ex.kernel_path}; additivity "
          f"{add_err:.3e}; |phi - single|={d_phi:.3e}; wall {wall:.3f} ms on {card}",
          flush=True)
    if sum(launches.values()) or ex.kernel_path.get("exact_phi") != "tn_dp" \
            or not add_err < ADDITIVITY:
        raise AssertionError("the tensor-train mesh explain is off")
    return total, worst


def cnn_train_phase(device, card, seed):
    """Phase 45: ``train_mnist_cnn`` on the card: ``CNN_TRAIN`` synthetic
    digits made from ``--seed``, one epoch in batches of ``CNN_BATCH``,
    accuracy above ``CNN_MIN_ACC`` on ``CNN_TEST`` more; then the trained
    probs head explained on ``B_CNN_EXPLAIN`` of them over the 49
    superpixels, the mean training image as the background,
    ``link='logit'``, ``l1_reg=False`` (the generic route, no hand kernel):
    finite, additive (1e-3).  Walls of the training and the explain."""

    import torch
    from distributedkernelshap_tpu_torch import KernelShap
    from distributedkernelshap_tpu_torch.models.cnn import train_mnist_cnn
    from distributedkernelshap_tpu_torch.ops.image import superpixel_groups

    rng = np.random.default_rng([seed, 45])
    templates = mnist_templates(rng)
    images, labels = synthetic_digits(CNN_TRAIN, rng, templates, with_labels=True)
    test, test_labels = synthetic_digits(CNN_TEST, rng, templates, with_labels=True)
    t0 = time.perf_counter()
    pred = train_mnist_cnn(images, labels, epochs=1, batch_size=CNN_BATCH, device=device)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    with torch.no_grad():
        probs = pred(torch.as_tensor(test, device=device))
    acc = float((probs.argmax(1).cpu().numpy() == test_labels).mean())
    groups, names = superpixel_groups(MNIST_SIDE, MNIST_SIDE, MNIST_PATCH)
    explainer = KernelShap(pred, link="logit", feature_names=names, seed=0, device=device)
    explainer.fit(images.mean(0, keepdims=True), group_names=names, groups=groups)
    reset_launches()
    t0 = time.perf_counter()
    expl = explainer.explain(test[:B_CNN_EXPLAIN], silent=True, l1_reg=False)
    torch.cuda.synchronize()
    explain_ms = 1e3 * (time.perf_counter() - t0)
    launches = kernel_launches()
    phi = np.stack(expl.shap_values, 1)
    add_err = additivity(expl)
    print(f"train_mnist_cnn on {card}: {CNN_TRAIN} digits, 1 epoch of "
          f"{CNN_TRAIN // CNN_BATCH} steps in {train_s:.3f} s; accuracy on {CNN_TEST} "
          f"held-out digits {acc:.3f} (> {CNN_MIN_ACC}); explain of {B_CNN_EXPLAIN} digits "
          f"over {len(groups)} superpixels: phi {phi.shape}, additivity {add_err:.3e}, "
          f"kernel_path {explainer.kernel_path}, launches {launches}, wall "
          f"{explain_ms:.3f} ms", flush=True)
    if not (acc > CNN_MIN_ACC and np.isfinite(phi).all() and add_err < ADDITIVITY
            and phi.shape == (B_CNN_EXPLAIN, MNIST_CLASSES, len(groups))):
        raise AssertionError("the CNN trained on the card is off")


# ---------------------------------------------------------------------- #
# the thirteenth slice (phases 46-47): several processes over
# torch.distributed — the cross-process mesh and a pod on the one card


#: seconds a worker process may take end to end, and the rendezvous /
#: collective timeout it runs under (a dead peer fails the other fast)
MP_WAIT_S, MP_TIMEOUT_S = 300, 120
#: phase 46's sampled layouts over two processes of one card each
MP_LAYOUTS = (("2x1", 1), ("1x2", 2))
#: phase 47: the bound on the pod's stop (drain handshake, both members out)
POD_STOP_S = 30.0


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_workers(case, world, out, seed, device):
    """``world`` processes of ``chip_smoke.py --mp-worker case``, one per
    rank, logging to files in ``out`` (a full pipe would stall the peer
    inside a collective), each wait bounded; every process is killed on the
    way out.  Returns each rank's result record; raises when a worker
    failed."""

    port = _free_port()
    procs, logs = [], [os.path.join(out, f"{case}_{r}.log") for r in range(world)]
    try:
        for r in range(world):
            with open(logs[r], "wb") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.join(REPO_ROOT, "chip_smoke.py"), "--seed",
                     str(seed), "--mp-worker", case, "--rank", str(r), "--world", str(world),
                     "--port", str(port), "--out", out, "--mp-device", str(device)],
                    cwd=REPO_ROOT, env=dict(os.environ, PYTHONPATH=REPO_ROOT),
                    stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + MP_WAIT_S
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(logs[r], errors="replace") as f:
                tail = f.read()[-4000:]
            raise AssertionError(f"{case} worker rank {r} exited {p.returncode}:\n{tail}")
    out_recs = []
    for r in range(world):
        with open(os.path.join(out, f"{case}_{r}.json")) as f:
            rec = json.load(f)
        arrays = np.load(os.path.join(out, f"{case}_{r}.npz"))
        rec["arrays"] = {k: arrays[k] for k in arrays.files}
        out_recs.append(rec)
    return out_recs


def _counted(fn):
    """``(result, {kernel: launches}, wall ms)`` of ``fn()`` with the counts
    set to 0 just before and read just after."""

    import torch

    reset_launches()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, kernel_launches(), 1e3 * (time.perf_counter() - t0)


def mp_worker(case, rank, world, port, out, seed, device):
    """One process of phase 46 (``python3 chip_smoke.py --mp-worker ...``):
    joins the group on ``127.0.0.1:port`` with ``device`` (the parent's,
    ``cuda:0``) as its card, runs
    its case with each path counted, holds every launch it made against
    the kernel's plain version on the same inputs, and writes
    ``<case>_<rank>.json`` / ``.npz`` into ``out``.

    * ``mesh`` (world 2, both ranks on the one card: gloo): the headline LR
      at 2×1 and 1×2, the fixture GBT's dense explain with interactions on
      ``MESH_BG_ODD`` background rows and its packed explain, both at 1×2;
    * ``nccl`` (world 1, a card of its own: NCCL): the headline LR at 1×1
      through ``KernelShap(distributed_opts={'n_devices': 1})``, and its phi
      through ``mesh.exchange`` (NCCL all-gathers) and ``broadcast_int``."""

    import torch
    from distributedkernelshap_tpu_torch import KernelShap
    from distributedkernelshap_tpu_torch.parallel.mesh import (
        broadcast_int,
        collective_backend,
        exchange,
        initialize_multihost,
        process_count,
    )

    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    t_join = time.perf_counter()
    initialize_multihost(f"127.0.0.1:{port}", world, rank, timeout_s=MP_TIMEOUT_S)
    rec = {"rank": rank, "backend": collective_backend(), "world": process_count(),
           "join_s": time.perf_counter() - t_join, "launches": {}, "want": {},
           "walls": {}, "errs": {"fused_linear_ey": 0.0, "exact_tree_phi": 0.0,
                                 "exact_tree_inter": 0.0}}
    arrays = {}
    X, bg, est = adult_task(seed)

    def lr(opts):
        ex = KernelShap(est.predict_proba, link="logit", feature_names=ADULT_GROUP_NAMES,
                        seed=0, device=device, distributed_opts=opts)
        return ex.fit(bg, group_names=ADULT_GROUP_NAMES, groups=adult_groups())

    def run_lr(label, ex):
        with recorded_ey_calls() as calls:
            expl, launches, wall = _counted(lambda: ex.explain(X, silent=True))
        rec["errs"]["fused_linear_ey"] = max(rec["errs"]["fused_linear_ey"],
                                             kernel_vs_plain_on(calls))
        dist = ex._explainer
        owned = len(dist.mesh.local_entries()) if hasattr(dist, "mesh") else 1
        rec["launches"][label], rec["walls"][label] = launches, wall
        rec["want"][label] = {"fused_linear_ey": owned, "exact_tree_phi": 0,
                              "exact_tree_inter": 0}
        arrays[label] = np.stack(expl.shap_values, 1)
        return arrays[label]

    if case == "nccl":
        phi = run_lr("1x1", lr({"n_devices": 1}))
        got = exchange({(0,): torch.as_tensor(phi, device=device)})
        rec["exchange_equal"] = bool(np.array_equal(got[(0,)].numpy(), phi))
        rec["broadcast"] = broadcast_int(11 + rank)
    else:
        for label, cp in MP_LAYOUTS:
            run_lr(label, lr({"n_devices": 2, "devices": [device], "coalition_parallel": cp}))
        fx = adult_fixture()
        Xe = fx["X"][:MESH_EXACT_ROWS]
        ex = fitted_fixture_tree(fx, fx["background"][:MESH_BG_ODD], device,
                                 {"n_devices": 2, "devices": [device], "coalition_parallel": 2})
        with recorded_exact_calls() as calls:
            expl, launches, wall = _counted(lambda: ex.explain(
                Xe, nsamples="exact", interactions=True, silent=True))
        errs = exact_vs_plain_on(calls)
        rec["launches"]["dense 1x2"], rec["walls"]["dense 1x2"] = launches, wall
        rec["want"]["dense 1x2"] = {"fused_linear_ey": 0, "exact_tree_phi": 1,
                                    "exact_tree_inter": 1}
        arrays["dense 1x2"] = exact_phi(expl, MESH_EXACT_ROWS)[0]
        arrays["dense 1x2 inter"] = interaction_values(expl, MESH_EXACT_ROWS)[0]
        ex = fitted_fixture_tree(fx, fx["background"], device,
                                 {"n_devices": 2, "devices": [device], "coalition_parallel": 2},
                                 pack_paths=True)
        from distributedkernelshap_tpu_torch.ops.treeshap import build_packed_plan

        plan = build_packed_plan(ex._explainer.engine.predictor, ex._explainer.engine.G,
                                 shards=2)
        with recorded_exact_calls() as calls:
            expl, launches, wall = _counted(lambda: ex.explain(Xe, nsamples="exact",
                                                               silent=True))
        for k, v in exact_vs_plain_on(calls).items():
            errs[k] = max(errs[k], v)
        rec["launches"]["packed 1x2"], rec["walls"]["packed 1x2"] = launches, wall
        rec["want"]["packed 1x2"] = {"fused_linear_ey": 0, "exact_tree_phi": len(plan.buckets),
                                     "exact_tree_inter": 0}
        arrays["packed 1x2"] = exact_phi(expl, MESH_EXACT_ROWS)[0]
        for k, v in errs.items():
            rec["errs"][k] = max(rec["errs"][k], v)
    np.savez(os.path.join(out, f"{case}_{rank}.npz"), **arrays)
    with open(os.path.join(out, f"{case}_{rank}.json"), "w") as f:
        json.dump(rec, f)
    return 0


def multiprocess_phase(X, bg, est, device, card, seed, phi_headline):
    """Phase 46: the cross-process mesh on the one card.  Two worker
    processes of this script (``mp_worker`` ``mesh``), each binding
    ``cuda:0`` and joining a gloo group (the card-UUID rule: two ranks on
    one card), run the headline LR at 2×1 and 1×2 and the fixture GBT's
    dense explain with interactions and packed explain at 1×2; then one
    worker at world size 1 (``nccl``: a card of its own) runs the 1×1 LR.
    Checks: the ranks' phi bit-equal; each layout within phases 43/44's
    bars of the one-process mesh of the same layout (LR 1e-3 + 16 p-ulps;
    exact 2e-5 × max(1, max|.|)), recomputed here; each rank's launches
    equal to the shards it owns (one slab); each worker's kernels against
    their plain versions on its own inputs; the NCCL run bit-equal to phase
    4's.  Returns ``({kernel: launches in the workers}, {kernel: worst
    kernel-vs-plain}, walls)``."""

    import tempfile

    import torch
    from distributedkernelshap_tpu_torch import KernelShap

    fx = adult_fixture()
    Xe = fx["X"][:MESH_EXACT_ROWS]
    refs = {}
    for label, cp in MP_LAYOUTS:
        ex = KernelShap(est.predict_proba, link="logit", feature_names=ADULT_GROUP_NAMES,
                        seed=0, device=device,
                        distributed_opts=_mesh_opts(device, 2, cp, None))
        ex.fit(bg, group_names=ADULT_GROUP_NAMES, groups=adult_groups())
        expl = ex.explain(X, silent=True)
        refs[label] = np.stack(expl.shap_values, 1)
        raw = expl.data["raw"]["raw_prediction"][:, 1]
    tol = logit_tol(raw)[:, None, None]
    ex = fitted_fixture_tree(fx, fx["background"][:MESH_BG_ODD], device,
                             _mesh_opts(device, 2, 2, None))
    expl = ex.explain(Xe, nsamples="exact", interactions=True, silent=True)
    refs["dense 1x2"] = exact_phi(expl, MESH_EXACT_ROWS)[0]
    refs["dense 1x2 inter"] = interaction_values(expl, MESH_EXACT_ROWS)[0]
    ex = fitted_fixture_tree(fx, fx["background"], device, _mesh_opts(device, 2, 2, None),
                             pack_paths=True)
    refs["packed 1x2"] = exact_phi(ex.explain(Xe, nsamples="exact", silent=True),
                                   MESH_EXACT_ROWS)[0]
    torch.cuda.synchronize()

    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        ranks = _spawn_workers("mesh", 2, out, seed, device)
        pair_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        (nccl,) = _spawn_workers("nccl", 1, out, seed, device)
        nccl_s = time.perf_counter() - t0
    total = {"fused_linear_ey": 0, "exact_tree_phi": 0, "exact_tree_inter": 0}
    errs = dict(total, fused_linear_ey=0.0, exact_tree_phi=0.0, exact_tree_inter=0.0)
    bad = []
    for rec in ranks + [nccl]:
        for label, launches in rec["launches"].items():
            if launches != rec["want"][label]:
                bad.append(f"rank {rec['rank']} {label}: launches {launches}, want "
                           f"{rec['want'][label]}")
            for k in total:
                total[k] += launches[k]
        for k in errs:
            errs[k] = max(errs[k], rec["errs"][k])
    if [r["backend"] for r in ranks] != ["gloo", "gloo"] or nccl["backend"] != "nccl":
        bad.append(f"backends {[r['backend'] for r in ranks]} / {nccl['backend']}, want "
                   "gloo for two ranks on one card and nccl for a card of its own")
    for label in refs:
        a0, a1 = ranks[0]["arrays"][label], ranks[1]["arrays"][label]
        same = bool(np.array_equal(a0, a1))
        d = np.abs(a0 - refs[label])
        ok = bool((d <= tol).all()) if label in dict(MP_LAYOUTS) else \
            bool(d.max() <= phi_tol(refs[label]))
        walls = [r["walls"].get(label.replace(" inter", ""), float("nan")) for r in ranks]
        print(f"multi-process {label} over 2 processes on the one card: ranks bit-equal "
              f"{same}; |phi - one-process mesh| max {d.max():.3e} (bit-equal "
              f"{bool(np.array_equal(a0, refs[label]))}); launches rank 0 "
              f"{ranks[0]['launches'].get(label.replace(' inter', ''))}, rank 1 "
              f"{ranks[1]['launches'].get(label.replace(' inter', ''))}; walls "
              f"{walls[0]:.3f} / {walls[1]:.3f} ms", flush=True)
        if not (same and ok):
            bad.append(f"{label}: ranks bit-equal {same}, within the bar {ok}")
    phi_nccl = nccl["arrays"]["1x1"]
    nccl_same = bool(np.array_equal(phi_nccl, phi_headline))
    print(f"multi-process NCCL world size 1: backend {nccl['backend']}, 1x1 launches "
          f"{nccl['launches']['1x1']}, phi bit-equal to phase 4's {nccl_same} (max diff "
          f"{np.abs(phi_nccl - phi_headline).max():.3e}), exchange round trip "
          f"{nccl['exchange_equal']}, broadcast {nccl['broadcast']}; wall "
          f"{nccl['walls']['1x1']:.3f} ms", flush=True)
    if not (nccl_same and nccl["exchange_equal"] and nccl["broadcast"] == 11):
        bad.append("the NCCL run differs from phase 4's or its collectives failed")
    print(f"multi-process on {card}: join {ranks[0]['join_s']:.3f} / {ranks[1]['join_s']:.3f} "
          f"s; the pair {pair_s:.1f} s, the NCCL worker {nccl_s:.1f} s (process starts "
          f"included); launches in the workers {total}; kernels vs plain {errs}", flush=True)
    if bad:
        raise AssertionError("multi-process mesh: " + "; ".join(bad))
    return total, errs


def _metric_lines(port, prefix):
    """``{series: value}`` of ``prefix`` on a member's ``/metrics``."""

    _, page = _http_get(f"http://127.0.0.1:{port}/metrics")
    return {ln.split(" ")[0]: float(ln.rsplit(" ", 1)[1])
            for ln in page.splitlines() if ln.startswith(prefix)}


def _last_pod_frame(port):
    """The last ``pod_frame`` event of a pod member's flight recorder
    (``/debugz``): the frames it served by command and its kernel launches
    after that frame's dispatch."""

    _, body = _http_get(f"http://127.0.0.1:{port}/debugz")
    events = [e for e in json.loads(body)["events"] if e["kind"] == "pod_frame"]
    if not events:
        raise AssertionError(f"no pod_frame event on 127.0.0.1:{port}/debugz")
    return events[-1]


def pod_phase(device, card):
    """Phase 47: a pod on the one card.  ``ReplicaManager(1,
    pod_processes=2, factory="chip_smoke:fleet_factory")``: a lead and a
    follower (``serving.main --coordinator``) on card 0, over the
    ``TCPStore`` wire, pipelined (``replicate_results``); the fixture LR's
    2560 rows as 256 requests of 10 from 16 threads through the proxy.
    Checks: served phi against the fixture and the direct explain (1e-4 +
    16 p-ulps, phase 39's bar); on each member ``fused_linear_ey`` launched
    once per frame it served (the last ``pod_frame`` event of each member's
    flight recorder at ``/debugz``: the lead's server, the follower's
    health listener); ``dks_pod_bcast_bytes_total`` above 0 on the lead; the stop
    runs the drain handshake and both members exit 0 within
    ``POD_STOP_S``, none left on the card.  Returns ``{kernel: launches on
    both members}`` and the walls."""

    from distributedkernelshap_tpu_torch.serving import client as cl
    from distributedkernelshap_tpu_torch.serving.replicas import ReplicaManager

    fx = adult_fixture()
    X = fx["X"][:SERVE_N_ROWS]
    requests = np.split(X, SERVE_N_ROWS // SERVE_ROWS_PER_REQUEST)
    factory = _fleet_factory_name(device)
    direct = np.stack(fixture_lr_explainer(fx, device).explain(X, silent=True).shap_values, 1)
    t0 = time.perf_counter()
    mgr = ReplicaManager(1, factory=factory, pod_processes=2, max_batch_size=SERVE_MAX_BATCH,
                         env_extra={"PYTHONPATH": REPO_ROOT}, startup_timeout_s=300.0,
                         restart=False)
    stopped = False
    try:
        mgr.start()
        pod = mgr.procs[0]
        _wait_until(lambda: mgr.proxy.replicas[0].alive, 300, "the pod")
        up_s = time.perf_counter() - t0
        ports = [mgr.ports[0], int(pod.members[1].args[pod.members[1].args.index("--port") + 1])]
        lat = []
        inner = cl.explain_request

        def timed(*a, **kw):
            t = time.perf_counter()
            res = inner(*a, **kw)
            lat.append(time.perf_counter() - t)
            return res

        cl.explain_request = timed
        try:
            t = time.perf_counter()
            payloads = cl.distribute_requests(
                f"http://127.0.0.1:{mgr.proxy.port}/explain", X, batch_mode="default",
                minibatches=requests, max_workers=SERVE_WORKERS, wire_format="binary")
            wall = time.perf_counter() - t
        finally:
            cl.explain_request = inner
        phi = np.concatenate([np.stack(p["shap_values"], 1) for p in payloads])
        d_fix, ok_fix = _fixture_ok(phi, fx, slice(0, SERVE_N_ROWS))
        tol = 1e-4 + LOGIT_ULPS * 2.0 ** -24 * (2.0 + 2.0 * np.cosh(
            fx["raw_prediction"][:SERVE_N_ROWS, 1]))
        d_direct = np.abs(phi - direct).max((1, 2))
        members = []
        for role, port in zip(("lead", "follower"), ports):
            event = _last_pod_frame(port)
            frames, launches = event["frames"], event["launches"]
            members.append((role, frames, launches, frames["explain"] + frames["warmup"]))
        bcast = _metric_lines(ports[0], "dks_pod_bcast_bytes_total{")
        pids = {m.pid for m in pod.members}
        t = time.perf_counter()
        mgr.stop()
        stopped = True
        stop_s = time.perf_counter() - t
        codes = [m.returncode for m in pod.members]
    finally:
        if not stopped:
            mgr.stop()
    print(f"pod (2 processes on card 0, {factory}): healthy behind the proxy after "
          f"{up_s:.3f} s; {SERVE_N_ROWS} rows as {len(requests)} binary requests of "
          f"{SERVE_ROWS_PER_REQUEST} from {SERVE_WORKERS} threads: wall {1e3 * wall:.3f} ms, "
          f"{SERVE_N_ROWS / wall:.1f} rows/s, {len(requests) / wall:.1f} requests/s, p50 "
          f"{_pct(lat, 50):.3f} ms, p99 {_pct(lat, 99):.3f} ms; |phi - fixture| max "
          f"{d_fix.max():.3e}, |phi - direct| max {d_direct.max():.3e} (1e-4 + {LOGIT_ULPS} "
          f"p-ulps); lead dks_pod_bcast_bytes_total {bcast}", flush=True)
    for role, frames, launches, served in members:
        print(f"pod {role}: frames {frames}; launches {launches}; fused_linear_ey launches "
              f"{launches['fused_linear_ey']} for {served} explain + warmup frames", flush=True)
    print(f"pod stop (drain handshake): {stop_s:.3f} s, member exit codes {codes} on {card}",
          flush=True)
    _check_released(pids, "pod")
    bad = []
    if not (ok_fix.all() and (d_direct <= tol).all()):
        bad.append("served phi off the fixture or the direct explain")
    for role, frames, launches, served in members:
        fle = launches["fused_linear_ey"]
        # a CPU rehearsal runs the plain versions, which count nothing
        if served < 1 or (_on_card(device) and fle != served):
            bad.append(f"{role}: fused_linear_ey {fle} launches for {served} frames")
    if not bcast or min(bcast.values()) <= 0:
        bad.append("no broadcast bytes on the lead")
    if codes != [0, 0] or stop_s > POD_STOP_S:
        bad.append(f"the pod stopped with {codes} in {stop_s:.1f} s")
    if members[0][1] != members[1][1]:
        bad.append("the members counted different frames")
    if bad:
        raise AssertionError("pod: " + "; ".join(bad))
    total = {}
    for _, _, launches, _ in members:
        for k, v in launches.items():
            total[k] = total.get(k, 0) + int(v)
    return total, {"wall": wall, "p50": _pct(lat, 50), "p99": _pct(lat, 99)}



# ---------------------------------------------------------------------- #
# the fourteenth slice (phases 48-49): the port's static gate on the card's
# machine, and the runtime lock witness under serving load on the card


#: phase 48: the bound on the gate's subprocess (the static pass itself
#: asserts its own 60 s budget)
GATE_TIMEOUT_S = 300
#: phase 49: requests of SERVE_ROWS_PER_REQUEST rows from this many client
#: threads, alternating between the LR and the GBT deployment; the GBT
#: requests' windows start this many rows apart inside the fixture's
#: tree_phi rows; the witness's hold budget (tests/conftest.py's) and the
#: bound on the witness process
WITNESS_REQUESTS, WITNESS_THREADS, WITNESS_GBT_STRIDE = 64, 8, 7
WITNESS_MAX_HOLD_S, WITNESS_WAIT_S = 30.0, 600


def _port_module_count() -> int:
    return sum(len([f for f in files if f.endswith(".py")])
               for root, _, files in os.walk(os.path.join(
                   REPO_ROOT, "distributedkernelshap_tpu_torch"))
               if "__pycache__" not in root)


def gate_phase(card):
    """Phase 48: ``python3 scripts/torch_lint.py --check`` in a subprocess
    on the card's machine (no JAX there): the three analyzer families over
    the port's sources, the observability drift check with the live catalog
    built on the card, and the alert engine's golden replay.  Requires exit
    0, no finding, no stale baseline entry, no parse error, the static pass
    under its budget, every module of the port scanned, the live catalog
    built on the card and nothing of JAX or of the JAX package loaded in
    that process.  Returns the report."""

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join(REPO_ROOT, "scripts", "torch_lint.py"),
                           "--check"], cwd=REPO_ROOT, capture_output=True, text=True,
                          timeout=GATE_TIMEOUT_S)
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-1]:
        print(f"gate: {line}", flush=True)
    try:
        report = json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        raise AssertionError(f"torch_lint.py --check printed no report (exit "
                             f"{proc.returncode}):\n{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    n_modules = _port_module_count()
    print(f"gate report: {json.dumps(report)}", flush=True)
    print(f"gate: scripts/torch_lint.py --check exit {proc.returncode} in {wall:.3f} s "
          f"(static pass {report.get('static_elapsed_s')} s of {report.get('static_budget_s')} "
          f"s); {report.get('files_scanned')} of {n_modules} port modules scanned; "
          f"obs-check on {report.get('obs_check_device')}; JAX modules loaded "
          f"{report.get('foreign_modules')} on {card}", flush=True)
    if proc.returncode != 0 or not report.get("ok") or report.get("findings") != 0 \
            or report.get("stale_baseline") != 0 or report.get("parse_errors") != 0 \
            or not report.get("static_elapsed_s", 1e9) < 60.0 \
            or report.get("files_scanned") != n_modules \
            or report.get("foreign_modules") != [] \
            or report.get("obs_check_problems") != 0 \
            or report.get("obs_check_device") != "cuda" \
            or report.get("health_check_ok") is not True:
        raise AssertionError("the port's gate is not green on the card's machine:\n"
                             + proc.stdout[-4000:] + proc.stderr[-2000:])
    return report


def witness_worker(out, seed, device):
    """The process of phase 49 (``python3 chip_smoke.py --mp-worker
    witness``), started with ``DKS_LOCK_WITNESS=1`` so that every named
    lock made in it, at import time too, is witnessed.  It serves phase
    39's fixture LR (staged, warmup ladder) and fixture GBT (auto-exact)
    from two ``ExplainerServer``s on ``device``, sends
    ``WITNESS_REQUESTS`` requests of ``SERVE_ROWS_PER_REQUEST`` rows from
    ``WITNESS_THREADS`` threads alternating between them, stops both, runs
    ``lockwitness.assert_clean(max_hold_s=WITNESS_MAX_HOLD_S)`` and writes
    ``witness.json``: launches over the request window, batches dispatched
    per deployment, the GBT plan's bucket count, served phi against the
    JAX fixture, the witness's acquisitions, edges and longest hold."""

    import concurrent.futures

    from distributedkernelshap_tpu_torch.analysis import lockwitness
    from distributedkernelshap_tpu_torch.serving import client as cl
    from distributedkernelshap_tpu_torch.serving.server import ExplainerServer
    from distributedkernelshap_tpu_torch.serving.wrappers import BatchKernelShapModel

    if not lockwitness.enabled():
        raise AssertionError("the witness process was started without DKS_LOCK_WITNESS=1")
    fx = adult_fixture()
    X = fx["X"]
    ks = fixture_lr_explainer(fx, device)
    tks = fitted_fixture_tree(fx, fx["background"], device)
    consts = tks._explainer._exact_consts()
    n_buckets = len(consts["plan"].buckets) if consts["packed"] is not None else 1
    reset_launches()
    tks.explain(X[:SERVE_TREE_REQUEST], nsamples="exact", silent=True)
    _sync(device)
    per_explain = kernel_launches()["exact_tree_phi"]

    models = {"lr": BatchKernelShapModel.from_explainer(ks),
              "gbt": BatchKernelShapModel.from_explainer(tks)}
    logs = {k: _BatchLog(m) for k, m in models.items()}
    servers = {}
    try:
        servers["lr"] = ExplainerServer(models["lr"], host="127.0.0.1", port=0,
                                        max_batch_size=SERVE_MAX_BATCH, warmup=True,
                                        staging=True).start()
        servers["gbt"] = ExplainerServer(models["gbt"], host="127.0.0.1", port=0,
                                         max_batch_size=SERVE_MAX_BATCH, pipeline_depth=4,
                                         warmup=False).start()
        for srv in servers.values():
            _wait_healthy(srv)
        jobs = []
        for i in range(WITNESS_REQUESTS):
            k, j = ("lr", "gbt")[i % 2], i // 2
            start = j * (SERVE_ROWS_PER_REQUEST if k == "lr" else WITNESS_GBT_STRIDE)
            jobs.append((k, np.arange(start, start + SERVE_ROWS_PER_REQUEST)))
        batches0 = {k: _metric_value(s, "dks_serve_batches_total")
                    for k, s in servers.items()}
        for log in logs.values():
            log.batches.clear()
            log.on = True
        reset_launches()
        latencies = []

        def send(job):
            k, rows = job
            t = time.perf_counter()
            ans = cl.explain_request(f"http://127.0.0.1:{servers[k].port}/explain", X[rows],
                                     wire_format="binary")
            latencies.append(time.perf_counter() - t)
            return ans

        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(WITNESS_THREADS) as pool:
            answers = list(pool.map(send, jobs))
        wall = time.perf_counter() - t0
        _sync(device)
        launches = kernel_launches()
        for log in logs.values():
            log.on = False
        batches = {k: int(_metric_value(s, "dks_serve_batches_total") - batches0[k])
                   for k, s in servers.items()}
        paths = {k: m.explain_path for k, m in models.items()}
    finally:
        for srv in servers.values():
            srv.stop()
    snap = lockwitness.assert_clean(max_hold_s=WITNESS_MAX_HOLD_S)

    d_lr, d_gbt, lr_ok = 0.0, 0.0, True
    for (k, rows), ans in zip(jobs, answers):
        if k == "lr":
            d, ok = _fixture_ok(np.stack(ans["shap_values"], 1), fx, rows)
            d_lr, lr_ok = max(d_lr, float(d.max())), lr_ok and bool(ok.all())
        else:
            d_gbt = max(d_gbt, rel_close(ans["shap_values"][0], fx["tree_phi"][rows]))
    holds = snap["max_hold_s"]
    longest = max(holds, key=holds.get) if holds else None
    rec = {
        "device": str(device), "launches": {k: int(v) for k, v in launches.items()},
        "batches": batches, "logged": {k: len(v.batches) for k, v in logs.items()},
        "paths": paths, "n_buckets": int(n_buckets), "per_explain": int(per_explain),
        "wall_s": wall, "p50_ms": _pct(latencies, 50), "p99_ms": _pct(latencies, 99),
        "d_lr": d_lr, "lr_ok": lr_ok, "d_gbt": d_gbt,
        "acquisitions": int(sum(snap["acquisitions"].values())),
        "locks": sorted(snap["acquisitions"]), "edges": len(snap["edges"]),
        "longest_hold": [longest, holds.get(longest, 0.0)],
        "overhead_s": snap["overhead_s"],
    }
    with open(os.path.join(out, "witness.json"), "w") as f:
        json.dump(rec, f)
    return 0


def witness_phase(device, card, seed):
    """Phase 49: :func:`witness_worker` in a fresh process with
    ``DKS_LOCK_WITNESS=1`` in its environment (locks made at import time
    escape ``force_enable``); it exits non-zero on a lock-order cycle or a
    hold over ``WITNESS_MAX_HOLD_S``.  Here: ``fused_linear_ey`` launched
    once per LR batch dispatched, ``exact_tree_phi`` once per bucket of
    the GBT's packed plan per GBT batch, ``exact_tree_inter`` never; served
    phi within phase 39's bars.  Returns ``({kernel: launches}, record)``."""

    import tempfile

    with tempfile.TemporaryDirectory() as out:
        log_path = os.path.join(out, "witness.log")
        t0 = time.perf_counter()
        with open(log_path, "wb") as log:
            proc = subprocess.Popen(
                [sys.executable, os.path.join(REPO_ROOT, "chip_smoke.py"), "--seed", str(seed),
                 "--mp-worker", "witness", "--out", out, "--mp-device", str(device)],
                cwd=REPO_ROOT, env=dict(os.environ, PYTHONPATH=REPO_ROOT, DKS_LOCK_WITNESS="1"),
                stdout=log, stderr=subprocess.STDOUT)
        try:
            rc = proc.wait(timeout=WITNESS_WAIT_S)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
        wall = time.perf_counter() - t0
        if rc != 0:
            with open(log_path, errors="replace") as f:
                raise AssertionError(f"the witness process exited {rc}:\n{f.read()[-4000:]}")
        with open(os.path.join(out, "witness.json")) as f:
            rec = json.load(f)
    lau, bat = rec["launches"], rec["batches"]
    want = {"fused_linear_ey": bat["lr"], "exact_tree_phi": rec["n_buckets"] * bat["gbt"],
            "exact_tree_inter": 0}
    print(f"lock witness (DKS_LOCK_WITNESS=1, fresh process, {wall:.1f} s with its start): "
          f"{WITNESS_REQUESTS} requests of {SERVE_ROWS_PER_REQUEST} rows from {WITNESS_THREADS} "
          f"threads over the fixture LR (path {rec['paths']['lr']}) and the fixture GBT (path "
          f"{rec['paths']['gbt']}): wall {1e3 * rec['wall_s']:.3f} ms, p50 {rec['p50_ms']:.3f} "
          f"ms, p99 {rec['p99_ms']:.3f} ms; batches {bat} (logged {rec['logged']}); launches "
          f"{lau} (want {want}; the GBT plan has {rec['n_buckets']} buckets, a direct explain "
          f"launched {rec['per_explain']}); |phi LR - JAX fixture| {rec['d_lr']:.3e} (1e-4 + "
          f"{LOGIT_ULPS} p-ulps: {rec['lr_ok']}), |phi GBT - tree_phi| {rec['d_gbt']:.3e}; "
          f"witness: {rec['acquisitions']} acquisitions of {len(rec['locks'])} named locks, "
          f"{rec['edges']} distinct lock-order edges, no cycle, longest hold "
          f"{rec['longest_hold'][1]:.6f} s ({rec['longest_hold'][0]}; budget "
          f"{WITNESS_MAX_HOLD_S:g} s), witness overhead {rec['overhead_s']:.6f} s on {card}",
          flush=True)
    bad = []
    if not rec["lr_ok"]:
        bad.append("served LR phi off the fixture")
    if rec["paths"] != {"lr": "sampled", "gbt": "exact"}:
        bad.append(f"paths {rec['paths']}")
    if bat["lr"] < 1 or bat["gbt"] < 1 or rec["logged"] != bat:
        bad.append(f"batches {bat} vs dispatches logged {rec['logged']}")
    if not any(n.startswith("server.") for n in rec["locks"]) \
            or "scheduler.cond" not in rec["locks"]:
        bad.append(f"the witness saw no server locks: {rec['locks']}")
    # a CPU rehearsal runs the plain versions, which count nothing
    if _on_card(device) and (any(lau[k] != v for k, v in want.items())
                             or rec["per_explain"] != rec["n_buckets"]):
        bad.append(f"launches {lau}, want {want}")
    if bad:
        raise AssertionError("lock witness: " + "; ".join(bad))
    return {k: int(lau[k]) for k in want}, rec


# ---------------------------------------------------------------------- #
# the fifteenth slice (phases 50-53): the kernels past their old limits


class MultinomialLogisticRegression:
    """A K-class multinomial logistic regression with scikit-learn's
    attributes (``coef_ (K, D)``, ``intercept_ (K,)``) and a numpy softmax
    ``predict_proba``: the port lifts it to one softmax ``LinearPredictor``."""

    def __init__(self, rng, K, D, scale=0.5):
        self.coef_ = rng.normal(scale=scale, size=(K, D))
        self.intercept_ = rng.normal(scale=0.5, size=K)

    def predict_proba(self, X):
        z = np.asarray(X, dtype=np.float64) @ self.coef_.T + self.intercept_
        e = np.exp(z - z.max(1, keepdims=True))
        return e / e.sum(1, keepdims=True)


def classes_explainer(est, bg, device, names, groups, use_kernel=None,
                      instance_chunk=None, transfer_dtype=None):
    """``KernelShap(est.predict_proba, link="logit")`` fitted on ``bg`` over
    the named groups."""

    from distributedkernelshap_tpu_torch import EngineConfig, KernelShap
    from distributedkernelshap_tpu_torch.ops.explain import ShapConfig

    explainer = KernelShap(est.predict_proba, link="logit", feature_names=names, seed=0,
                           device=device, engine_config=EngineConfig(
                               shap=ShapConfig(use_kernel=use_kernel,
                                               transfer_dtype=transfer_dtype),
                               instance_chunk=instance_chunk))
    return explainer.fit(bg, group_names=names, groups=groups)


def ey_timing(args, sm_count, sm_clock_hz, reps=3):
    """Kernel and plain version of ``fused_linear_ey`` by CUDA events on one
    call's arguments, and the call's bound: ``(kernel_ms, plain_ms,
    bound_ms, bound_by)``."""

    from distributedkernelshap_tpu_torch.ops.cuda_kernels import (
        fused_linear_ey,
        fused_linear_ey_plain,
    )

    XWg, bgWg, _, _, mask, activation = args
    B, M, K = XWg.shape
    kernel_ms = cuda_time_ms(lambda: fused_linear_ey(*args), reps)
    plain_ms = cuda_time_ms(lambda: fused_linear_ey_plain(*args), 1)
    bound_ms, bound_by = ey_bound_ms(B, mask.shape[0], bgWg.shape[0], M, K, activation,
                                     sm_count, sm_clock_hz)
    return kernel_ms, plain_ms, bound_ms, bound_by


def general_softmax_report(label, args, kernel_ms, bound_ms, bound_by, sm_count,
                           sm_clock_hz, card):
    """Print what a general-softmax ``fused_linear_ey`` call launches
    (``ey_launch_info`` of the kernel its route takes,
    ``softmax_factored_kernel_regs`` up to ``ey_regs_max_k`` classes, else
    ``softmax_factored_kernel``: blocks, registers, local memory, which must
    be 0, shared memory, resident blocks per SM), the kernel's time
    against its bound (the factored count) and against the earlier count
    (``design="unfactored"``: K exps and a reciprocal per activation), with
    the share of each.  Returns the earlier count in ms."""

    from distributedkernelshap_tpu_torch.ops.cuda_kernels import ey_launch_info

    XWg, bgWg, _, _, mask = args[:5]
    B, M, K = XWg.shape
    S, N = mask.shape[0], bgWg.shape[0]
    info = ey_launch_info(B, S, N, M, K, "softmax")
    kernel = {"regs": "softmax_factored_kernel_regs"}.get(info["route"],
                                                           "softmax_factored_kernel")
    old_ms, old_by = ey_bound_ms(B, S, N, M, K, "softmax", sm_count, sm_clock_hz,
                                 design="unfactored")
    if info["local_bytes"]:
        raise AssertionError(f"{kernel} spills at K={K}: {info}")
    print(f"{label}: {kernel} (after softmax_v_kernel) at B={B} S={S} N={N} "
          f"M={M} K={K} on {card}: launch {info} ({info['local_bytes']} B local memory a "
          f"thread); kernel {kernel_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
          f"factored: B·S·N reciprocals, K·(B·S + S·N) exps, 2·K·B·S·N FFMAs) "
          f"{100 * bound_ms / kernel_ms:.1f}% of it; the earlier count {old_ms:.4f} ms "
          f"({old_by}: an exp per (b, s, n, k), a reciprocal per (b, s, n)) "
          f"{100 * old_ms / kernel_ms:.1f}%", flush=True)
    return old_ms


def classes_phase(X, bg, device, card, sm_count, sm_clock_hz, seed):
    """Phase 50: a 100-class multinomial LR on the Adult-shaped task (B =
    2560, D = 48 in the Adult groups, N = 100, M = 12, S = 2072) through
    ``KernelShap(...).fit(...).explain(X)``, counted: one
    ``fused_linear_ey`` launch, through the factored kernel; additive
    (< 1e-3), phi within ``PHI_ATOL`` + 16 p-ulps (``logit_tol``) of the
    plain route on the card and of the port on the CPU on the first rows;
    the kernel against its plain version on the call's own arguments;
    times.  Returns the record of the call."""

    import torch
    from distributedkernelshap_tpu_torch.ops.cuda_kernels import fused_linear_ey

    rng = np.random.default_rng([seed, 50])
    B, K, M = X.shape[0], N_CLASSES_WIDE, len(ADULT_WIDTHS)
    est = MultinomialLogisticRegression(rng, K, X.shape[1], scale=0.3)
    explainer = classes_explainer(est, bg, device, ADULT_GROUP_NAMES, adult_groups())
    fused_linear_ey.launches = 0
    fused_linear_ey.route_launches = dict.fromkeys(fused_linear_ey.route_launches, 0)
    with recorded_ey_calls() as calls:
        t0 = time.perf_counter()
        expl = explainer.explain(X, silent=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches, path = fused_linear_ey.launches, explainer.kernel_path
    routes = dict(fused_linear_ey.route_launches)
    a = calls[0][0] if calls else None
    print(f"classes: {K}-class LR, B={B} M={M}: launches fused_linear_ey={launches} "
          f"(want 1; by route {routes}), kernel_path={path}, the call: XWg "
          f"{tuple(a[0].shape)}, mask {tuple(a[4].shape)}, {a[5]}, ey "
          f"{(B, a[4].shape[0], K)} float32 = {4 * B * a[4].shape[0] * K / 1e9:.2f} GB; "
          f"first explain wall {wall:.3f} s on {card}", flush=True)
    if launches != 1 or len(calls) != 1 or path.get("ey") != "cuda" \
            or routes["factored"] != 1:
        raise AssertionError("the 100-class explain did not launch fused_linear_ey's "
                             "factored kernel once")
    phi, add_err = check_explanation(expl, B, K, M)
    raw = np.asarray(expl.data["raw"]["raw_prediction"])
    tol = logit_tol(raw)[:, :, None]
    plain = classes_explainer(est, bg, device, ADULT_GROUP_NAMES, adult_groups(),
                              use_kernel=False)
    d_plain = np.abs(phi - check_explanation(plain.explain(X, silent=True), B, K, M)[0])
    n = N_CLASSES_CPU
    cpu = classes_explainer(est, bg, "cpu", ADULT_GROUP_NAMES, adult_groups())
    d_cpu = np.abs(phi[:n] - check_explanation(cpu.explain(X[:n], silent=True), n, K, M)[0])
    ey_err = kernel_vs_plain_on(calls)
    print(f"classes: additivity={add_err:.3e} (< {ADDITIVITY:g}); |phi kernel - phi plain "
          f"route| max {d_plain.max():.3e}, |phi card - phi cpu| (first {n} rows) max "
          f"{d_cpu.max():.3e} (tol {PHI_ATOL:g} + {LOGIT_ULPS} p-ulps, {tol.min():.3e}.."
          f"{tol.max():.3e}); ey kernel vs plain on the call {ey_err:.3e} (tol {EY_ATOL:g}); "
          f"max|phi|={np.abs(phi).max():.3f}", flush=True)
    if not ((d_plain <= tol).all() and (d_cpu <= tol[:n]).all()):
        raise AssertionError("the 100-class explain disagrees with its references")
    wall_ms, walls = median_wall_ms(lambda: explainer.explain(X, silent=True), 3)
    kernel_ms, plain_ms, bound_ms, bound_by = ey_timing(a, sm_count, sm_clock_hz)
    print(f"times on {card}: {K}-class explain B={B} wall median of 3 = {wall_ms:.3f} ms "
          f"(runs {walls}); fused_linear_ey at B={B} S={a[4].shape[0]} N={a[1].shape[0]} "
          f"M={M} K={K}: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms; library_ms "
          f"null", flush=True)
    old_ms = general_softmax_report(f"classes K={K}", a, kernel_ms, bound_ms, bound_by,
                                    sm_count, sm_clock_hz, card)
    return {"launches": launches, "max_abs_err": ey_err, "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_ms_unfactored": old_ms}


def covertype_rows(rng, n):
    """``n`` rows shaped like the processed Covertype data
    (``scripts/process_covertype_data.py``'s synthetic fallback): 10
    standard-normal numeric columns, a one-hot wilderness area of 4 and a
    one-hot soil type of 40, each drawn from Dirichlet class shares."""

    numeric = rng.normal(size=(n, 10))
    wild = np.eye(4)[rng.choice(4, n, p=rng.dirichlet(np.full(4, 2.0)))]
    soil = np.eye(40)[rng.choice(40, n, p=rng.dirichlet(np.full(40, 0.5)))]
    return np.concatenate([numeric, wild, soil], 1).astype(np.float32)


def covertype_groups():
    groups, start = [], 0
    for w in COVERTYPE_WIDTHS:
        groups.append(list(range(start, start + w)))
        start += w
    return groups


def covertype_phase(device, card, sm_count, sm_clock_hz, seed):
    """Phase 51: the JAX package's configuration 5 with a seeded lookalike
    (54 columns in 12 groups, a 7-class multinomial LR): all 581,012 rows
    explained with ``EngineConfig(instance_chunk=65536)`` and
    ``transfer_dtype='float16'``, counted (one ``fused_linear_ey`` launch
    per instance chunk, each call printed), then ``rank_features``
    (counted); the first chunk in float32 additive (< 1e-3) and the float16
    phi within atol 1e-3 / rtol 2e-3 of it; wall, rows/s, the top feature;
    the kernel against its plain version on a call's first rows; times.
    Returns the record of the first call."""

    import torch
    from distributedkernelshap_tpu_torch.ops.cuda_kernels import (
        fused_linear_ey,
        fused_linear_ey_plain,
    )

    rng = np.random.default_rng([seed, 51])
    X = covertype_rows(rng, COVERTYPE_ROWS)
    K, M, C = COVERTYPE_CLASSES, len(COVERTYPE_WIDTHS), COVERTYPE_CHUNK
    est = MultinomialLogisticRegression(rng, K, X.shape[1], scale=0.8)
    explainer = classes_explainer(est, X[:N_BACKGROUND], device, COVERTYPE_NAMES,
                                  covertype_groups(), instance_chunk=C,
                                  transfer_dtype="float16")
    n_chunks = -(-X.shape[0] // C)
    fused_linear_ey.launches = 0
    fused_linear_ey.route_launches = dict.fromkeys(fused_linear_ey.route_launches, 0)
    with recorded_ey_calls() as calls:
        t0 = time.perf_counter()
        expl = explainer.explain(X, silent=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches, path = fused_linear_ey.launches, explainer.kernel_path
    routes = dict(fused_linear_ey.route_launches)
    for i, (a, _) in enumerate(calls):
        print(f"covertype call {i}: fused_linear_ey XWg {tuple(a[0].shape)} bgWg "
              f"{tuple(a[1].shape)} mask {tuple(a[4].shape)} {a[5]}: ey "
              f"({a[0].shape[0]}, {a[4].shape[0]}, {K}) float32 = "
              f"{4 * a[0].shape[0] * a[4].shape[0] * K / 1e9:.2f} GB", flush=True)
    print(f"covertype: {X.shape[0]} rows, D={X.shape[1]} in M={M} groups, K={K}: launches "
          f"fused_linear_ey={launches} (want {n_chunks}, one per {C}-row instance chunk; by "
          f"route {routes}), kernel_path={path}; wall {wall:.3f} s, "
          f"{X.shape[0] / wall:.0f} rows/s on {card}", flush=True)
    if launches != n_chunks or len(calls) != n_chunks or path.get("ey") != "cuda" \
            or routes["regs"] != n_chunks:
        raise AssertionError("the Covertype explain did not launch fused_linear_ey's "
                             "small-K route once per instance chunk")
    phi16 = np.stack(expl.shap_values, 1)
    if phi16.shape != (X.shape[0], K, M) or not np.isfinite(phi16).all():
        raise AssertionError(f"bad Covertype shap values: shape {phi16.shape}")
    exact32 = classes_explainer(est, X[:N_BACKGROUND], device, COVERTYPE_NAMES,
                                covertype_groups(), instance_chunk=C)
    phi32, add32 = check_explanation(exact32.explain(X[:C], silent=True), C, K, M)
    d16 = np.abs(phi16[:C] - phi32)
    f16_ok = bool((d16 <= F16_ATOL + F16_RTOL * np.abs(phi32)).all())
    fused_linear_ey.launches = 0
    fused_linear_ey.route_launches = dict.fromkeys(fused_linear_ey.route_launches, 0)
    t0 = time.perf_counter()
    ranked = explainer.rank_features(X)
    torch.cuda.synchronize()
    t_rank = time.perf_counter() - t0
    rank_launches = fused_linear_ey.launches
    rank_routes = dict(fused_linear_ey.route_launches)
    top = ranked["aggregated"]["names"][0]
    print(f"covertype: first chunk in float32 additivity={add32:.3e} (< {ADDITIVITY:g}); "
          f"float16 phi vs float32 max {d16.max():.3e} within atol {F16_ATOL:g} / rtol "
          f"{F16_RTOL:g}: {f16_ok}; rank_features over all rows {t_rank:.3f} s on {card}, "
          f"launches fused_linear_ey={rank_launches} (by route {rank_routes}), top feature "
          f"{top!r}", flush=True)
    if not f16_ok or rank_launches < 1 or rank_routes["regs"] != rank_launches:
        raise AssertionError("the Covertype float16 phi or the ranking failed")
    a = calls[0][0]
    sub = (a[0][:2048].contiguous(),) + tuple(a[1:])
    ey_err = float((fused_linear_ey(*sub) - fused_linear_ey_plain(*sub)).abs().max())
    if not ey_err <= EY_ATOL:
        raise AssertionError(f"fused_linear_ey vs plain {ey_err:.3e} on a Covertype call")
    kernel_ms, plain_ms, bound_ms, bound_by = ey_timing(a, sm_count, sm_clock_hz)
    print(f"times on {card}: Covertype fused_linear_ey at B={a[0].shape[0]} "
          f"S={a[4].shape[0]} N={a[1].shape[0]} M={M} K={K}: kernel {kernel_ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms; kernel vs plain on the first 2048 rows {ey_err:.3e}; "
          f"library_ms null", flush=True)
    old_ms = general_softmax_report("Covertype chunk", a, kernel_ms, bound_ms, bound_by,
                                    sm_count, sm_clock_hz, card)
    return {"launches": launches, "max_abs_err": ey_err, "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_ms_unfactored": old_ms, "wall_s": wall, "rows_per_s": X.shape[0] / wall,
            "top_feature": top}


def wide_rows(rng, n, D):
    """``n`` rows of ``D`` columns, 3/5 standard normal and the rest 0/1."""

    n_cont = 3 * D // 5
    return np.concatenate([rng.normal(size=(n, n_cont)),
                           rng.integers(0, 2, size=(n, D - n_cont))], 1).astype(np.float32)


def wide_gbt(seed, D, T=N_TREES):
    """A GBT over ``D`` columns grown as phase 6's, with rows to explain and
    a background: ``(tables, X (B_EXACT, D), bg (N_BACKGROUND, D))``."""

    rng = np.random.default_rng([seed, 52, D])
    tables = grow_gbt(rng, wide_rows(rng, 2000, D), T)
    return tables, wide_rows(rng, B_EXACT, D), wide_rows(rng, N_BACKGROUND, D)


def wide_exact_run(tables, X, bg, device, pack_paths, want):
    """One ungrouped exact explain of ``X``, counted (``want`` launches of
    ``exact_tree_phi``), checked against the plain route, the CPU port on
    the first rows and itself.  Returns ``(explainer, phi, launches, worst
    difference)``."""

    import torch
    from distributedkernelshap_tpu_torch.ops.cuda_kernels import exact_tree_phi

    B, M = X.shape
    route = "packed" if pack_paths else "dense"
    exact_tree_phi.launches = 0
    explainer, expl = explain_exact(tables, X, bg, device, pack_paths=pack_paths,
                                    grouped=False)
    torch.cuda.synchronize()
    launches, path = exact_tree_phi.launches, explainer.kernel_path
    packed_on = explainer._explainer._exact_consts()["packed"] is not None
    print(f"wide exact M={M} {route} route: launches exact_tree_phi={launches} (want "
          f"{want}), kernel_path={path}", flush=True)
    if launches != want or path != {"exact_phi": "cuda"} or packed_on != bool(pack_paths):
        raise AssertionError(f"the M={M} exact {route} explain did not go through "
                             "exact_tree_phi as planned")
    phi, add_err = exact_phi(expl, B, M)
    again, _ = exact_phi(explainer.explain(X, nsamples="exact", silent=True), B, M)
    _, expl_plain = explain_exact(tables, X, bg, device, pack_paths=pack_paths,
                                  use_kernel=False, grouped=False)
    d_plain = float(np.abs(phi - exact_phi(expl_plain, B, M)[0]).max())
    n = N_WIDE_CPU
    _, expl_cpu = explain_exact(tables, X[:n], bg, "cpu", pack_paths=pack_paths,
                                grouped=False)
    d_cpu = float(np.abs(phi[:n] - exact_phi(expl_cpu, n, M)[0]).max())
    tol = phi_tol(phi)
    bitwise = bool(np.array_equal(phi, again))
    print(f"wide exact M={M} {route} route: additivity={add_err:.3e} (< "
          f"{EXACT_ADDITIVITY:g}); |phi kernel - phi plain route|={d_plain:.3e}, |phi card "
          f"- phi cpu| (first {n} rows)={d_cpu:.3e} (tol {tol:.2e}); repeat bit-identical="
          f"{bitwise}; max|phi|={np.abs(phi).max():.4f}", flush=True)
    if not (d_plain <= tol and d_cpu <= tol and bitwise):
        raise AssertionError(f"the M={M} exact {route} explain disagrees with its references")
    return explainer, phi, launches, max(d_plain, d_cpu)


def check_slot_table(label, args):
    """The slot-table kernel (``cuda_kernels.slot_table``) against its plain
    version on the card at these inputs: the table and the counts must be
    equal."""

    import torch
    from distributedkernelshap_tpu_torch.ops.cuda_kernels import _slot_table_plain, slot_table

    got, counts = slot_table(args[0], args[1])
    ref, ref_counts = _slot_table_plain(args[0], args[1])
    torch.cuda.synchronize()
    same = bool(torch.equal(got, ref) and torch.equal(counts, ref_counts))
    print(f"slot table kernel vs plain [{label}] P={got.shape[0]}: equal={same}, most "
          f"groups on a path {int(counts.max())}", flush=True)
    if not same:
        raise AssertionError(f"the slot-table kernel disagrees with its plain version at {label}")


def wide_exact_phase(device, card, sm_count, sm_clock_hz, seed):
    """Phase 52: exact TreeSHAP past 63 groups.  A GBT over 100 ungrouped
    columns (50 trees, <= 31 leaves, random splits, as phase 6's) explained
    with ``nsamples='exact'`` at B = 256, N = 100 on the packed and the
    dense route (one launch per depth bucket, one dense), and one over 300
    columns at B = 64 on the dense route, each counted, additive, against
    the plain route, the CPU and itself (:func:`wide_exact_run`);
    ``exact_tree_phi`` against its plain version at the dense inputs and
    at M in {64, 100, 300} x dmax in {1, 30, 64} with all-live and
    none-live edges, bit-identical repeats; dmax = 65 past 64 groups
    raises; the by-slot tile kernel's build and occupancy; times.  Returns
    the record."""

    import torch
    from distributedkernelshap_tpu_torch.ops.cuda_kernels import (
        exact_tree_phi,
        exact_tree_phi_plain,
    )
    from distributedkernelshap_tpu_torch.ops.explain import groups_to_matrix
    from distributedkernelshap_tpu_torch.ops.treeshap import build_packed_plan

    tables, X, bg = wide_gbt(seed, M_WIDE)
    plan = build_packed_plan(tree_predictor(tables, "cpu"), groups_to_matrix(None, M_WIDE))
    print(f"wide exact: GBT over {M_WIDE} ungrouped columns, T={N_TREES}, depth "
          f"{tables['depth']}, plan: live paths {plan.n_live}, gain {plan.gain:.3f}, "
          f"buckets {plan.buckets}", flush=True)
    _, _, packed_launches, worst = wide_exact_run(tables, X, bg, device, True,
                                                  len(plan.buckets))
    dense_explainer, _, dense_launches, d = wide_exact_run(tables, X, bg, device, False, 1)
    worst = max(worst, d)
    tables3, X3, bg3 = wide_gbt(seed, M_WIDEST)
    wide3, _, launches3, d = wide_exact_run(tables3, X3[:B_WIDEST], bg3, device, False, 1)
    worst = max(worst, d)

    rng = np.random.default_rng([seed, 52])
    cases = [(f"dense inputs M={M_WIDE}",) + dense_inputs(dense_explainer, X, device),
             (f"dense inputs M={M_WIDEST}",) + dense_inputs(wide3, X3[:B_WIDEST], device)]
    cases += [(f"M={M} dmax={dmax} {kind}",
               phi_edge_inputs(rng, 32, 100, 130, M, 2, device, kind, path_groups=dmax),
               dmax)
              for M, dmax, kind in WIDE_PHI_EDGES]
    for name, args, dmax in cases:
        check_slot_table(name, args)
        got = exact_tree_phi(*args, dmax=dmax)
        again = exact_tree_phi(*args, dmax=dmax)
        ref = exact_tree_phi_plain(*args, dmax=dmax)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        tol = phi_tol(ref.cpu().numpy())
        same = bool(torch.equal(got, again))
        print(f"exact_tree_phi vs plain [{name}] B,P,N,M,K="
              f"{tuple(args[0].shape[:2]) + (args[2].shape[0], args[0].shape[2], args[4].shape[1])}"
              f" dmax={dmax}: max_abs_diff={err:.3e} (tol {tol:.2e}), bit-identical "
              f"repeat={same}", flush=True)
        if not (bool(got.isfinite().all()) and err <= tol and same):
            raise AssertionError(f"exact_tree_phi disagrees with its plain version or "
                                 f"with itself at {name}")
        worst = max(worst, err)
    try:
        exact_tree_phi(*phi_edge_inputs(rng, 4, 8, 8, M_WIDE, 1, device, path_groups=64),
                       dmax=65)
    except ValueError as e:
        print(f"exact_tree_phi at M={M_WIDE} dmax=65 raises on the card: {e}", flush=True)
    else:
        raise AssertionError("exact_tree_phi took dmax=65 past 64 groups")
    for M, K in ((M_WIDE, 1), (M_WIDEST, 1), (M_WIDEST, 2)):
        tile_report("exact_tree_phi", "phi_tile_kernel<u64, 64, true>", M, K)
    times = {}
    for name, args, dmax in cases[:2]:
        k_ms = cuda_time_ms(lambda: exact_tree_phi(*args, dmax=dmax), 20)
        p_ms = cuda_time_ms(lambda: exact_tree_phi_plain(*args, dmax=dmax), 2)
        b_ms, b_by, counts = phi_bound_ms(args, sm_count, sm_clock_hz)
        times[name] = (k_ms, p_ms, b_ms, b_by)
        print(f"times on {card}: exact_tree_phi [{name}] dmax={dmax}: kernel {k_ms:.4f} ms, "
              f"plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
              f"{100 * b_ms / k_ms:.1f}% of bound; counts {counts}; library_ms null",
              flush=True)
    k_ms, p_ms, b_ms, b_by = times[cases[0][0]]
    return {"launches": {"packed": packed_launches, "dense": dense_launches,
                         "dense_m300": launches3},
            "max_abs_err": worst, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": b_by}


def wide_inter_phase(device, card, sm_count, sm_clock_hz, seed):
    """Phase 53: exact interactions at M = 64 (the reference's cap): a GBT
    over 64 ungrouped columns explained with ``interactions=True`` at B =
    64, counted (one ``exact_tree_inter`` and one dense ``exact_tree_phi``
    launch); symmetric, rows summing to phi (1e-5), within 2e-5·max(1,
    max|·|) of the plain route and the CPU on the first rows, bit-identical
    repeats; ``exact_tree_inter`` against its plain version at the dense
    inputs (atol = rtol = 3e-5), bit-identical; M = 65 raises at the
    wrapper and at the explain; the slot walk's build and occupancy; times.
    Returns ``(record, the dense phi launch's max |kernel - plain|)``."""

    import torch
    from distributedkernelshap_tpu_torch.ops.cuda_kernels import (
        exact_tree_inter,
        exact_tree_inter_plain,
        exact_tree_phi,
        exact_tree_phi_plain,
    )

    M, B, n = M_INTER_WIDE, B_INTER_WIDE, N_WIDE_CPU
    tables, X, bg = wide_gbt(seed, M)
    X = X[:B]
    exact_tree_inter.launches = exact_tree_phi.launches = 0
    explainer, expl = explain_exact(tables, X, bg, device, interactions=True, grouped=False)
    torch.cuda.synchronize()
    launches, phi_launches = exact_tree_inter.launches, exact_tree_phi.launches
    path = explainer.kernel_path
    print(f"wide interactions M={M}: launches exact_tree_inter={launches} (want 1), "
          f"exact_tree_phi={phi_launches} (want 1, dense), kernel_path={path}", flush=True)
    if launches != 1 or phi_launches != 1 or path != {"exact_phi": "cuda",
                                                      "exact_inter": "cuda"}:
        raise AssertionError("the M=64 interaction explain did not go through "
                             "exact_tree_inter and exact_tree_phi as planned")
    inter, sym, rows = interaction_values(expl, B, M)
    again, _, _ = interaction_values(
        explainer.explain(X, nsamples="exact", silent=True, interactions=True), B, M)
    _, expl_plain = explain_exact(tables, X, bg, device, use_kernel=False,
                                  interactions=True, grouped=False)
    d_plain = float(np.abs(inter - interaction_values(expl_plain, B, M)[0]).max())
    _, expl_cpu = explain_exact(tables, X[:n], bg, "cpu", interactions=True, grouped=False)
    d_cpu = float(np.abs(inter[:n] - interaction_values(expl_cpu, n, M)[0]).max())
    tol = phi_tol(inter)
    bitwise = bool(np.array_equal(inter, again))
    print(f"wide interactions M={M}: shape {inter.shape}, asymmetry {sym:.3e}, |row sums "
          f"- phi| {rows:.3e} (tol {CONVENTION_ATOL:g}); |kernel - plain route|="
          f"{d_plain:.3e}, |card - cpu| (first {n} rows)={d_cpu:.3e} (tol {tol:.2e}); "
          f"repeat bit-identical={bitwise}; max|inter|={np.abs(inter).max():.4f}", flush=True)
    if not (d_plain <= tol and d_cpu <= tol and bitwise):
        raise AssertionError("the M=64 interaction explain disagrees with its references")

    args, dmax = dense_inputs(explainer, X, device)
    check_slot_table(f"dense inputs M={M}", args)
    got = exact_tree_inter(*args, dmax=dmax)
    same = bool(torch.equal(got, exact_tree_inter(*args, dmax=dmax)))
    err, close = raw_close(got, exact_tree_inter_plain(*args, dmax=dmax))
    phi_got = exact_tree_phi(*args, dmax=dmax)
    phi_ref = exact_tree_phi_plain(*args, dmax=dmax)
    phi_err = float((phi_got - phi_ref).abs().max())
    phi_same = bool(torch.equal(phi_got, exact_tree_phi(*args, dmax=dmax)))
    phi_ok = phi_err <= phi_tol(phi_ref.cpu().numpy())
    print(f"exact_tree_inter vs plain [dense inputs M={M}] B,P,N={tuple(args[0].shape[:2])}"
          f"+({args[2].shape[0]},) dmax={dmax}: max_abs_diff={err:.3e} (atol = rtol = "
          f"{RAW_TOL:g}: {close}), bit-identical repeat={same}; the dense exact_tree_phi "
          f"launch vs plain {phi_err:.3e} ({phi_ok}), bit-identical={phi_same}", flush=True)
    if not (close and same and phi_ok and phi_same):
        raise AssertionError("exact_tree_inter or the dense exact_tree_phi disagrees at M=64")
    rng = np.random.default_rng([seed, 53])
    try:
        exact_tree_inter(*phi_edge_inputs(rng, 4, 8, 8, M + 1, 1, device), dmax=3)
    except ValueError as e:
        print(f"exact_tree_inter at M={M + 1} raises on the card: {e}", flush=True)
    else:
        raise AssertionError("exact_tree_inter took M=65")
    tables65, X65, bg65 = wide_gbt(seed, M + 1, T=5)
    try:
        explain_exact(tables65, X65[:4], bg65, device, interactions=True, grouped=False)
    except ValueError as e:
        print(f"the interaction explain at M={M + 1} raises: {e}", flush=True)
    else:
        raise AssertionError("the interaction explain took M=65")
    tile_report("exact_tree_inter", "inter_slot_kernel<u64, true>", M, 1)
    tile_report("exact_tree_inter", "inter_slot_kernel<unsigned, false>", 32, 3)
    k_ms = cuda_time_ms(lambda: exact_tree_inter(*args, dmax=dmax), 20)
    p_ms = cuda_time_ms(lambda: exact_tree_inter_plain(*args, dmax=dmax), 1)
    b_ms, b_by, counts = inter_bound_ms(args, sm_count, sm_clock_hz)
    print(f"times on {card}: exact_tree_inter [dense inputs M={M}] B={B} dmax={dmax}: "
          f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
          f"{100 * b_ms / k_ms:.1f}% of bound; counts {counts}; library_ms null", flush=True)
    return ({"launches": launches, "phi_launches": phi_launches,
             "max_abs_err": max(err, d_plain, d_cpu), "ms": k_ms, "plain_ms": p_ms,
             "bound_ms": b_ms, "bound_by": b_by}, phi_err)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    # one process of phase 46, started by the script itself
    ap.add_argument("--mp-worker", choices=("mesh", "nccl", "witness"), default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--mp-device", default="cuda:0", help=argparse.SUPPRESS)
    args = ap.parse_args()
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    if args.mp_worker == "witness":
        return witness_worker(args.out, args.seed, args.mp_device)
    if args.mp_worker:
        return mp_worker(args.mp_worker, args.rank, args.world, args.port, args.out,
                         args.seed, args.mp_device)

    from distributedkernelshap_tpu_torch.ops import cuda_kernels

    # 1. device
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    props = torch.cuda.get_device_properties(0)
    print(f"device: {kind}; nvidia-smi: {card}; SMs={props.multi_processor_count}; "
          f"torch {torch.__version__} CUDA {torch.version.cuda}", flush=True)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on; the port computes in full f32")

    # 2. build
    t0 = time.perf_counter()
    libs = cuda_kernels.build()
    for name, path in libs.items():
        print(f"built {name}: {path} in {time.perf_counter() - t0:.1f} s", flush=True)
    ey_info = ey_kernel_report(libs["fused_linear_ey"], props.multi_processor_count)
    exact_kernel_report(libs)

    # 3. kernel vs plain
    max_err = compare_kernel(args.seed, device)

    # 4. main path, counted
    X, bg, est = adult_task(args.seed)
    cuda_kernels.fused_linear_ey.launches = 0
    explainer, expl = explain_headline(X, bg, est, device)
    torch.cuda.synchronize()
    launches = cuda_kernels.fused_linear_ey.launches
    path = explainer.kernel_path
    print(f"main path: launches fused_linear_ey={launches}, kernel_path={path}", flush=True)
    if launches < 1 or path.get("ey") != "cuda":
        raise AssertionError("the headline explain did not go through fused_linear_ey")
    phi, add_err = check_explanation(expl, B_HEADLINE)
    _, expl_plain = explain_headline(X, bg, est, device, use_kernel=False)
    phi_plain, _ = check_explanation(expl_plain, B_HEADLINE)
    d_route = float(np.abs(phi - phi_plain).max())
    n_small = 64
    _, expl_cpu = explain_headline(X[:n_small], bg, est, "cpu")
    d_cpu = float(np.abs(phi[:n_small] - check_explanation(expl_cpu, n_small)[0]).max())
    print(f"main path: additivity={add_err:.3e} (< {ADDITIVITY:g}); |phi kernel - phi "
          f"plain route|={d_route:.3e}, |phi card - phi cpu| (first {n_small} rows)="
          f"{d_cpu:.3e} (tol {PHI_ATOL:g}); max|phi|={np.abs(phi).max():.3f}", flush=True)
    if not (d_route <= PHI_ATOL and d_cpu <= PHI_ATOL):
        raise AssertionError("the headline explain disagrees with its references")

    # 5. times
    wall_ms, walls = median_wall_ms(lambda: explainer.explain(X, silent=True), 3)
    S = explainer._explainer._plan(None).n_rows
    M, N, K = len(ADULT_WIDTHS), N_BACKGROUND, 2
    ey_args = group_space_inputs(np.random.default_rng(args.seed), B_HEADLINE, S, N, M, K,
                                 device, explainer._explainer._plan(None).mask)
    kernel_ms = cuda_time_ms(lambda: cuda_kernels.fused_linear_ey(*ey_args, "softmax"), 50)
    plain_ms = cuda_time_ms(lambda: cuda_kernels.fused_linear_ey_plain(*ey_args, "softmax"), 10)
    clock = max_sm_clock_hz()
    floors = {d: ey_bound_ms(B_HEADLINE, S, N, M, K, "softmax", props.multi_processor_count,
                             clock, design=d)
              for d in ("paired", "factored", "unfactored")}
    bound_ms, bound_by = floors["paired"]
    print(f"times on {card}: explain B={B_HEADLINE} wall median of 3 = {wall_ms:.3f} ms "
          f"(runs {walls}); fused_linear_ey at B={B_HEADLINE} "
          f"S={S} N={N} M={M} K={K}: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}: half a reciprocal per activation, "
          f"paired), {100 * bound_ms / kernel_ms:.1f}% of bound; the design's floor "
          f"{floors['factored'][0]:.4f} ms (one reciprocal per activation), "
          f"{100 * floors['factored'][0] / kernel_ms:.1f}% of it; the unfactored form's "
          f"{floors['unfactored'][0]:.4f} ms (exp + reciprocal per activation), "
          f"{100 * floors['unfactored'][0] / kernel_ms:.1f}% of it; "
          f"{ey_info['registers']} registers, {ey_info['blocks_per_sm']} blocks/SM; "
          f"library_ms null: no single PyTorch call computes this function", flush=True)

    # 6-7. exact TreeSHAP
    tables = adult_shaped_gbt(args.seed)
    exact_record = exact_phase(tables, X, bg, device, props.multi_processor_count,
                               clock, card, args.seed)

    # 8-9. exact Shapley interactions
    inter_record, phi_dense_err = inter_phase(tables, X, bg, device,
                                              props.multi_processor_count,
                                              clock, card, args.seed)
    exact_record["max_abs_err"] = max(exact_record["max_abs_err"], phi_dense_err)

    # 10-13. the sampled engine: packed copy, l1 selection, plan constants,
    # device-side importance
    packed_transfer_phase(explainer, expl, X, bg, est, device)
    max_err = max(max_err, l1_phase(X, bg, est, device, card))
    plan_constant_phase(explainer, X, bg, est, device, card)
    importance_phase(explainer, expl, X)

    # 14-16. the non-linear sampled paths, each phase's seconds
    seconds = {}
    t = time.perf_counter()
    sampled_tree_phase(tables, X, bg, device, card)
    seconds["14 sampled tree"] = time.perf_counter() - t
    t = time.perf_counter()
    phi_mlp = mlp_phase(X, bg, device, card, args.seed)
    seconds["15 mlp"] = time.perf_counter() - t
    t = time.perf_counter()
    blackbox_phase(X, bg, device, card, args.seed, phi_mlp)
    seconds["16 black box"] = time.perf_counter() - t

    # 17-20. the engine's serving entry points
    t = time.perf_counter()
    chunked_phase(tables, X, bg, est, device, card, phi)
    seconds["17 chunked"] = time.perf_counter() - t
    t = time.perf_counter()
    staging_phase(explainer, tables, X, bg, device, card)
    seconds["18 staging"] = time.perf_counter() - t
    t = time.perf_counter()
    max_err = max(max_err, anytime_phase(explainer, X, bg, est, device, card,
                                         props.multi_processor_count, clock))
    seconds["19 anytime"] = time.perf_counter() - t
    t = time.perf_counter()
    profiler_checkpoint_phase(explainer, expl, tables, X, bg, device, card)
    seconds["20 profiler, checkpoint"] = time.perf_counter() - t

    # 22-28. booster dumps, the affine head, the IsolationForest shape, tensor
    # trains, the singular Gram, the headline's WLS host time, the fixture
    t = time.perf_counter()
    booster_phi_err, booster_inter_err = boosters_phase(tables, X, bg, device, card)
    exact_record["max_abs_err"] = max(exact_record["max_abs_err"], booster_phi_err)
    inter_record["max_abs_err"] = max(inter_record["max_abs_err"], booster_inter_err)
    seconds["22 boosters"] = time.perf_counter() - t
    t = time.perf_counter()
    affine_phase(tables, X, bg, device, card)
    seconds["23 affine head"] = time.perf_counter() - t
    t = time.perf_counter()
    iforest_phase(X, bg, device, card, args.seed)
    seconds["24 isolation forest"] = time.perf_counter() - t
    t = time.perf_counter()
    tn_phase(device, card, args.seed)
    seconds["25 tensor train"] = time.perf_counter() - t
    t = time.perf_counter()
    singular_gram_phase(device)
    seconds["26 singular Gram"] = time.perf_counter() - t
    t = time.perf_counter()
    wls_host_phase(explainer, X, card)
    seconds["27 WLS host time"] = time.perf_counter() - t
    t = time.perf_counter()
    fixture_phase(device, card)
    seconds["28 fixture"] = time.perf_counter() - t

    # 29-33. scikit-learn compositions, SVMs and Gaussian classifiers
    t = time.perf_counter()
    max_err = max(max_err, pipeline_phase(X, bg, device, card, args.seed))
    seconds["29 pipeline"] = time.perf_counter() - t
    t = time.perf_counter()
    svm_phase(X, bg, device, card, args.seed)
    seconds["30 svm"] = time.perf_counter() - t
    t = time.perf_counter()
    max_err = max(max_err, ensemble_phase(tables, X, bg, device, card, args.seed))
    seconds["31 ensembles"] = time.perf_counter() - t
    t = time.perf_counter()
    family_phase(tables, X, bg, device, card, args.seed)
    seconds["32 families"] = time.perf_counter() - t
    t = time.perf_counter()
    compose_fixture_phase(device, card)
    seconds["33 compose fixture"] = time.perf_counter() - t

    # 34-38. the graph lift, DeepSHAP, the MNIST CNN and superpixel images
    t = time.perf_counter()
    graph_ops_phase(device, card, args.seed)
    seconds["34 graph ops"] = time.perf_counter() - t
    t = time.perf_counter()
    onnx_linear_phase(X, bg, est, device, card, phi)
    seconds["35 onnx linear"] = time.perf_counter() - t
    t = time.perf_counter()
    deepshap_exact_phase(device, card, args.seed)
    seconds["36 deepshap exact"] = time.perf_counter() - t
    fx_mnist = load_deepshap_fixture()
    X_mnist, train_mnist = mnist_task(args.seed)
    t = time.perf_counter()
    mnist_deepshap_phase(fx_mnist, X_mnist, train_mnist, device, card)
    seconds["37 mnist deepshap"] = time.perf_counter() - t
    t = time.perf_counter()
    mnist_sampled_phase(fx_mnist, X_mnist, train_mnist, device, card)
    seconds["38 mnist sampled"] = time.perf_counter() - t

    # 39. the single-process explanation server
    t = time.perf_counter()
    serving = serving_phase(device, card)
    seconds["39 serving"] = time.perf_counter() - t

    # 40-42. the shard journal, the multi-tenant gateway, the replica fleet
    t = time.perf_counter()
    journal_phase(device, card)
    seconds["40 journal"] = time.perf_counter() - t
    t = time.perf_counter()
    gateway = gateway_phase(device, card, args.seed)
    seconds["41 gateway"] = time.perf_counter() - t
    t = time.perf_counter()
    fleet_phase(device, card, serving["single"])
    seconds["42 fleet"] = time.perf_counter() - t

    # 43-45. one process over a mesh of devices, train_mnist_cnn
    t = time.perf_counter()
    mesh_ey, mesh_ey_err = mesh_headline_phase(X, bg, est, device, card, expl)
    max_err = max(max_err, mesh_ey_err)
    seconds["43 mesh headline"] = time.perf_counter() - t
    t = time.perf_counter()
    mesh_exact, mesh_exact_err = mesh_exact_phase(device, card, args.seed)
    exact_record["max_abs_err"] = max(exact_record["max_abs_err"],
                                      mesh_exact_err["exact_tree_phi"])
    inter_record["max_abs_err"] = max(inter_record["max_abs_err"],
                                      mesh_exact_err["exact_tree_inter"])
    seconds["44 mesh exact"] = time.perf_counter() - t
    t = time.perf_counter()
    cnn_train_phase(device, card, args.seed)
    seconds["45 cnn training"] = time.perf_counter() - t

    # 46-47. several processes over torch.distributed: the cross-process
    # mesh, a pod behind the fleet's proxy
    t = time.perf_counter()
    mp_launches, mp_errs = multiprocess_phase(X, bg, est, device, card, args.seed, phi)
    max_err = max(max_err, mp_errs["fused_linear_ey"])
    exact_record["max_abs_err"] = max(exact_record["max_abs_err"], mp_errs["exact_tree_phi"])
    inter_record["max_abs_err"] = max(inter_record["max_abs_err"], mp_errs["exact_tree_inter"])
    seconds["46 multi-process mesh"] = time.perf_counter() - t
    t = time.perf_counter()
    pod_launches, _ = pod_phase(device, card)
    seconds["47 pod"] = time.perf_counter() - t

    # 48-49. the port's static gate on this machine, the lock witness under
    # serving load on the card
    t = time.perf_counter()
    gate_phase(card)
    seconds["48 gate"] = time.perf_counter() - t
    t = time.perf_counter()
    witness, _ = witness_phase(device, card, args.seed)
    seconds["49 lock witness"] = time.perf_counter() - t

    # 50-53. the kernels past their old limits: 100 classes, Covertype, exact
    # TreeSHAP past 63 groups, exact interactions at 64
    t = time.perf_counter()
    classes = classes_phase(X, bg, device, card, props.multi_processor_count, clock,
                            args.seed)
    max_err = max(max_err, classes["max_abs_err"])
    seconds["50 100 classes"] = time.perf_counter() - t
    t = time.perf_counter()
    covertype = covertype_phase(device, card, props.multi_processor_count, clock, args.seed)
    max_err = max(max_err, covertype["max_abs_err"])
    seconds["51 covertype"] = time.perf_counter() - t
    t = time.perf_counter()
    wide_exact = wide_exact_phase(device, card, props.multi_processor_count, clock,
                                  args.seed)
    exact_record["max_abs_err"] = max(exact_record["max_abs_err"], wide_exact["max_abs_err"])
    seconds["52 exact past 63 groups"] = time.perf_counter() - t
    t = time.perf_counter()
    wide_inter, wide_inter_phi_err = wide_inter_phase(device, card,
                                                      props.multi_processor_count, clock,
                                                      args.seed)
    inter_record["max_abs_err"] = max(inter_record["max_abs_err"], wide_inter["max_abs_err"])
    exact_record["max_abs_err"] = max(exact_record["max_abs_err"], wide_inter_phi_err)
    seconds["53 interactions at 64"] = time.perf_counter() - t
    print("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items())
          + f"; script so far {time.perf_counter() - t_start:.1f}", flush=True)

    exact_record["serving_launches"] = serving["exact_tree_phi"]
    inter_record["serving_launches"] = serving["exact_tree_inter"]
    exact_record["gateway_launches"] = gateway["exact_tree_phi"]
    inter_record["gateway_launches"] = gateway["exact_tree_inter"]
    exact_record["mesh_launches"] = mesh_exact["exact_tree_phi"]
    inter_record["mesh_launches"] = mesh_exact["exact_tree_inter"]
    # launches inside the worker processes of phases 46 (both ranks and the
    # NCCL worker) and 47 (both pod members)
    multi = {k: mp_launches[k] + pod_launches.get(k, 0) for k in mp_launches}
    exact_record["multiprocess_launches"] = multi["exact_tree_phi"]
    inter_record["multiprocess_launches"] = multi["exact_tree_inter"]
    exact_record["witness_launches"] = witness["exact_tree_phi"]
    inter_record["witness_launches"] = witness["exact_tree_inter"]
    # the fifteenth slice's paths (phases 50-53): launches, and each new
    # shape's kernel and plain times and bound
    exact_record["wide_launches"] = dict(wide_exact["launches"],
                                         interactions_m64=wide_inter["phi_launches"])
    exact_record["wide_m100"] = {k: wide_exact[k] for k in ("ms", "plain_ms", "bound_ms",
                                                            "bound_by")}
    inter_record["wide_launches"] = wide_inter["launches"]
    inter_record["wide_m64"] = {k: wide_inter[k] for k in ("ms", "plain_ms", "bound_ms",
                                                           "bound_by")}
    wide_ey = {name: {k: rec[k] for k in ("launches", "ms", "plain_ms", "bound_ms",
                                          "bound_by", "bound_ms_unfactored")}
               for name, rec in (("k100", classes), ("covertype", covertype))}
    print(f"card: {card}")
    print(json.dumps({"kernels": [{
        "name": "fused_linear_ey", "route": "cuda",
        "source": "distributedkernelshap_tpu_torch/csrc/fused_linear_ey.cu",
        "replaces": "distributedkernelshap_tpu/ops/pallas_kernels.py:497",
        "launches": launches, "max_abs_err": max_err, "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "serving_launches": serving["fused_linear_ey"],
        "gateway_launches": gateway["fused_linear_ey"], "mesh_launches": mesh_ey,
        "multiprocess_launches": multi["fused_linear_ey"],
        "witness_launches": witness["fused_linear_ey"], "wide": wide_ey},
        exact_record, inter_record]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
