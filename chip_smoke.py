#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gptorch_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --compare-side [CHECKOUT]

The second form runs only this script's kernel phases (the same list as
the first) on the package of CHECKOUT (a ``git archive`` of another
commit; this directory by default), then K4 over ranks 9 to 32 and the
matrix-free value-and-grad with its stages from CHECKOUT's chip_smoke.py:
one side of a comparison of two commits on one card, run in one call as
parent, change, change, parent.

1. Builds every hand-written kernel from the sources in the checkout, one
   nvcc per source, all started together; K3's and K4's (most of the
   build) finish in the background while phases 3-6, which launch only K1
   and K2, run, and the kernel phases follow them.
2. Kernel phases (after phase 6): each kernel against its plain PyTorch
   twin on the card,
   with its time (CUDA events, warm), the plain version's time and the least
   time the card could take (bytes over 3.35 TB/s or operations over the
   peak rate, whichever is larger).
   Each K1 case prints two times: "call", a loop of calls from the host
   (what a caller waits for; a small Gram's is the host's), and "device",
   the card's time alone (launches captured in one CUDA graph and
   replayed).
   - K1 ``rbf_gram``: the exact-GP serving and training shapes (d = 8)
     and the sparse paths' (d = 9: Kuu 1024², Kuf 1024 × 4096, Kus
     1024 × 256, ragged 1000 × 4000) in float32 and float64, and its
     backward against autograd through the plain twin; then its batched
     launch at the fleet's shapes (256 Grams of 512², with a var and diag
     per member, and 256 cross Grams of 512 × 256).
   - K2 ``radial_contractions``: the five radial kinds in float32 and
     float64 at n = 4096, and rbf in float32 at the training shape
     n = 32768; then the five kinds timed at n = 32768 in float32, each
     with its GB/s and share of the bound.
3. Serving phase (main path 1): the exact-GP serving path at the flagship
   width, n = 32768, d = 8, Rbf-ARD, Gaussian(0.1), fixed jitter, float32:
   GPR -> posterior() -> for_serving() -> 8 batches of 256 queries through
   predict_f and mean_only.  Checks: finite outputs, serving vs the
   triangular-solve posterior, and a float64 rerun at n = 4096 where the
   card's route and the CPU's plain route agree to 1e-8.
4. Training phase (main path 2): bench.py's headline leg, n = 32768, d = 8,
   Rbf-ARD, Gaussian(0.1), fast=True, fast_block=1024, fast_jitter=1e-3,
   float32, through ``model.fit_scan("Adam", max_iter=4,
   learning_rate=1e-4)`` (a captured CUDA graph): one warm call, then one
   timed call, then the first call's steps again eagerly from the same
   values (losses within 1e-6).  Stage times of one value-and-grad.
   Checks: finite, decreasing losses; NLML and
   gradient in float32 against the same computation in float64 at
   n = 32768; and at n = 4096 in float64 the card's route against the CPU's
   on the fused radial, generic and kernel-general paths, the composite
   Linear + Rbf + Constant, the leave-one-out objective, and inputs too
   wide for the contraction kernel (d = 33, dy = 33: general on the card,
   fused on the CPU).
5. General training (main path 3): the same data with the composite
   Linear + Rbf + Constant on the kernel-general path, ``fit_scan`` Adam
   (a warm and a timed call of 2 steps), ``predict_f_samples`` (256 x 64)
   and ``predict_f``, then ``optimize("L-BFGS-B", max_iter=2)``.  Checks:
   the samples' moments against ``predict_f``, stage times with bounds,
   NLML and gradient in float32 against float64 at n = 32768.
6. Observe loop (main path 4): the serving cell's model, ``posterior()``,
   ``fantasy_chain(capacity=n + 64)``, 32 ``observe`` calls of 2 points,
   ``for_serving()``, ``sample_paths(16, 1024)`` on both posteriors over
   4096 candidates.  Checks: the chain against a refit of the augmented
   data and against ``condition_on`` on both posteriors, the paths finite
   and the same for the same seed; the stages of one observe.
7. Sparse training (main path 5): bench_svgp.py's configuration, SVGP at
   n = 45730, d = 9, m = 1024, batch 4096, Rbf-ARD, Gaussian(), jitter
   1e-6, fixed jitter policy, float32, through ``model.fit_scan("Adam",
   max_iter=50, learning_rate=1e-2, generator=...)``: one warm call, one
   timed call (ms/step, steps/s, CUDA-event span), the device's busy time
   per step from ``torch.profiler`` and the idle share, stage times of one
   value-and-grad.  Checks: finite losses whose last 10 average below the
   first 10; the full-batch ELBO and gradient in float32 against float64 on
   the card; and at n = 4096, m = 256 in float64 the card's route against
   the CPU's for SVGP (both parameterizations), VFE, FITC and one natural-
   gradient step.
8. Sparse serving (main paths 6 and 7): a VFE on all n = 45730 points
   (sharing the trained SVGP's kernel, likelihood and inducing inputs) and
   the trained SVGP, each through posterior() -> for_serving() -> 8 batches
   of 256, serving against the triangular-solve posterior; and one VFE
   value-and-grad at full n.
9. svgp_captured: the SVGP cell trained eagerly and by fit_scan's captured
   CUDA graph from one seed: identical minibatch indices (recorded on the
   card), losses within 1e-5 relative; both loops' ms/step, busy ms and
   idle share.
10. dkl_studentt_svgp: DeepKernel(Rbf(2), MLP([9, 64, 64, 2])) with a
   StudentT(df=4) likelihood in an SVGP at the sparse cell, 50 + 50
   captured Adam steps, for_serving().predict_f; the ELBO and gradient in
   float64 card vs CPU at n = 4096, m = 128.
11. zoo_grams: the eleven new kernels' Grams at (32768, 32768), d = 8,
   float32, with ms, peak memory and the write bound; each against the
   CPU in float64 at (2048, 2048).
12. zoo_training: GPR with Rbf(ARD)·ExpSinSquared(ARD) + SpectralMixture
   (Q = 4) at bench.py's n = 32768, d = 8, float32, on the kernel-general
   path, fit_scan L-BFGS (3 iterations; eager, host reads per
   evaluation), posterior().predict_f; the Gram's and the chunked VJP's
   times and peaks.  Before phase 11, in float64 at n = 4096, the loss,
   gradient and three L-BFGS iterations on the card, held (after phase
   15's card work) against the CPU's loss and gradient and its losses at
   the card's iterates, which a background process of this script computes
   while the card runs phases 11-15.
13. Kernel phases of the matrix-free exact GP: K3 ``gram_mvm`` (the five
   kinds in float32 and float64 at n = 4096 and 4097 with k = 1, 9 and
   256) and K4 ``lowrank_contractions`` (the same with r = 9 and 17), each
   launched twice and bitwise equal, then timed at n = 100000, d = 8,
   float32 (K3 with k = 9, 1 and 17: mBCG's block at 8 probes, a Lanczos
   vector, and GPR(solver="iterative")'s default 16 probes; K4 with
   r = 9 and 17, the same probes with dy = 1).  They run right after the
   K2 phase.
14. iterative_training: bench_iterative.py's model at bench.py's
   n = 100000, d = 8 (GPR(solver="iterative"), 8 probes, 128 CG steps,
   rank-64 preconditioner, tolerance 1e-4, float32): one warm and two timed
   value-and-grads, ``fit_scan("Adam", 2)`` (eager by fit.captures' rule),
   the stages of one value-and-grad, ``iterative_diagnostics()``, and the
   NLML and gradient in float32 against float64 at full n.
15. iterative_serving: ``posterior(love_rank=256)`` of that model, 8
   batches of 256 queries through predict_f, then one CG-exact predict_f
   of 16 queries; the means must agree.  Then in float64 at n = 4096 the
   card against the CPU: loss, gradient, α, LOVE variances, diagnostics,
   the CPU's side computed by a background process of this script
   (``--iterative-cpu-reference PATH``) on half the host's cores from the
   start of phase 11 (the zoo's, whose readings the card bounds), so that
   the host-bound readings of phases 3-10 run on an idle host.
16. psi_statistics: bench_ekernels.py's cell (n = 1000, m = 50, q = 10,
   Rbf-ARD, float32): ψ₀ + Σψ₁ + Σψ₂ and its value-and-grad (the kernel's
   hyperparameters and Xmean), float32 against float64 on the card, and ψ₂
   per datum at the sparse width (256 queries, m = 1024, q = 9).
17. gplvm: the Bayesian GPLVM at the oil-flow data's shape (n = 1000,
   p = 12, q = 10, m = 50, synthetic Y from a seed, float32): fit_scan
   Adam (captured), posterior(), predict_f at the latents,
   predict_uncertain over 256, project of 16 new rows, impute; then in
   float64 at a small shape the card against the CPU for the iid,
   dynamical and reparameterized priors, large p and the Linear ψ-kernel.
18. uncertain_prediction: predict_uncertain of VFE and SVGP at the sparse
   cell (256 queries) and of GPR at n = 4096, d = 8 (16 queries), all with
   ekernels.Rbf(ARD); each finite, and in float64 on the card equal to
   predict_f at zero input variance.
19. vecchia: bench_vecchia.py's cell (n = 200000, d = 3, m = 32, chunk
   8192, float32): the host build, a value-and-grad and its stages,
   float32 against float64 NLML, fit_scan Adam (captured), predict_f of 8
   batches of 256, peak memory; full history against the dense GPR at
   n = 512 and the card against the CPU at n = 4096, in float64.
   Phases 16-19 print the seconds they took together.
20. statespace: bench_ssgp.py's cell (Matern32(1, ℓ = 0.5), Gaussian(0.1),
   x ~ U(0, 1000) sorted, float32) at bench.py's n = 65536: one warm and
   two timed value-and-grads, the stages of the forward (assemble and
   discretize, the element build, the scan, the NLML, the smoother), the
   device launches of one value-and-grad, fit_scan Adam (captured), peak
   memory, predict_f of 8 batches of 256, predict_f_samples(16) over 256,
   filter_moments; then at bench_ssgp.py's n = 10⁶ the chunked scan's
   value-and-grad and peak memory.  Checks: float32 against float64 NLML
   and gradient at both n; in float64 at n = 4096 the card against the CPU
   for Matern12/32/52 and Matern32 + Matern52 (s = 5), chunked (1024) and
   not; the state-space GP against the dense GPR at n = 2048 (1e-9); the
   moments of 512 joint draws against predict_f.
21. kronecker: GridGPR on the 64 × 64 × 64 grid (N = 262144) with Rbf(1)
   per axis (K1 builds each axis Gram and cross Gram), Gaussian(0.1), y
   from a seed, float32: a value-and-grad and its stages (the three eighs,
   the mode products), fit_scan Adam (eager: eigh reads the host),
   posterior(), predict_f of 8 batches of 256 off-grid queries and of 64
   with diag=False.  Checks: in float64 on a 16 × 12 × 10 grid the card
   against the CPU, and the GridGPR against the dense GPR with the product
   kernel.
22. ski: bench_calibration.py's 3-D SKI row (Matern32(1, ℓ = 0.5) per axis,
   grid 16³, Gaussian(0.01), 16 probes, 256 CG steps, tolerance 1e-6) at
   bench.py's matrix-free n = 100000 on bench_calibration.make_data's
   recipe, float32: a value-and-grad and its stages (one product split
   into Wᵀ, the Toeplitz FFTs and W; mBCG; SLQ), two value-and-grads
   bitwise equal, posterior(), predict_mean over 8 × 256, predict_f of 16.
   Check: in float64 at n = 2048 (CG to 1e-11, noise 0.1 so it converges)
   the card against the CPU.
   Phases 20-22 print the seconds they took together.
23. ensemble: bench_ensemble.py's cell (GPEnsemble of B = 256 members, n =
   512, d = 4, Rbf-ARD, y = sin(Σx) + 0.1ε from RandomState(0), float32): a
   value-and-grad (one K1 launch for the fleet's 256 Grams, checked) and
   its device launches, fit_scan Adam (lr 0.05) under the fixed jitter
   policy (captured) and the default adaptive one (eager), one member's
   step alone (the serial comparison of bench_ensemble.py, x B),
   predict_f of 256 shared queries, best().  Checks: float32 against
   float64 losses and gradient (4·u·κ, κ of the worst member); member_at
   against the fleet; in float64 at B = 4, n = 256 the card against the
   CPU and member_at(i) against a standalone GPR; a fleet whose member 2
   alone is singular gets that member the jitter level the standalone
   adaptive cholesky picks.
24. multioutput: ICM at n = 4096, d = 8, p = 4, rank 2, Rbf-ARD (κ spread,
   see icm_model): a value-and-grad, the two eighs, posterior(), predict_f
   of 8 batches of 256, predict_f_joint of 64.  LMC at bench_svgp.py's
   cell with p = 4 outputs from L = 3 latent Rbf-ARD GPs: fit_scan Adam 50
   steps (fixed jitter, captured), 5 stacked-q natural steps,
   lmc_posterior, predict_f of 8 batches of 256.  Checks: in float64 the
   card against the CPU, ICM at n = 512 and LMC at n = 2048, m = 64 (one
   explicit batch, one natural step).
25. derivative: DerivativeGPR at n = 2048, d = 8, Rbf-ARD (the joint system
   18432²), targets and gradients of sin(x·w): a value-and-grad and its
   stages (the joint Gram, the factor), predict_f and predict_grad of 256.
   Check: in float64 at n = 128, d = 3 the card against the CPU.
26. exact_variants: TPR and WarpedGPR (3 tanh terms) at n = 32768 and
   LaplaceGP (Bernoulli) at n = 8192, d = 8, Rbf-ARD, on bench.py's data:
   a value-and-grad each, predict_f of 256 (predict_quantiles for the
   warped GP).  Checks: float32 against float64 loss and gradient at half
   n (4·u·κ; the Laplace GP's LAPLACE_F32_TOL, which its controls with
   TF32 products and with K1's Grams rounded to float16 must fail), and in
   float64 at n = 512 the card against the CPU.
   Phases 23-26 print the seconds they took together; in the kernels line
   the fleet, ICM, LMC, the derivative GP, TPR, the warped GP and the
   Laplace GP are each a path of their own.
27. heteroscedastic: HeteroscedasticSVGP at bench_svgp.py's cell (its
   inputs and inducing inputs, y = sin(x₀) + e^{g/2}·ε with g = −4 +
   2·tanh(x₁), Rbf-ARD for both latents, batch 4096, fixed jitter): a
   value-and-grad and its stages (each latent's moments, the ELBO),
   fit_scan Adam (captured), natural steps over both q groups, predict_y
   and predict_log_density per 256.  Checks: float32 against float64 loss
   and gradient on one batch (HS_F32_TOL, which its controls with TF32
   products and with K1's Grams scaled by 1 + 2⁻¹¹ must each fail); in
   float64 at n = 2048, m = 64 the card against the CPU on one explicit
   batch.
28. deep: DeepGP in Salimbeni & Deisenroth's UCI setup on the cell's data
   (M = 100 per layer, widths (9, 9): three layers, one sample in
   training, all n = 45730 points): value-and-grad, a value-and-grad on a
   batch of 10000, fit_scan Adam (captured), predict_f per 256 with 20
   samples; one K1 launch per layer's K(Z, F) whatever the samples (the
   sample axis is a batched Gram), checked at S = 1 and 4.  Checks: K1's
   gradient into F against the plain twin; in float64 at n = 512 the card
   against the CPU with the draws held fixed.
29. streaming: StreamingVFE (fixed seeded hyperparameters, ekernels.Rbf)
   streaming the cell's n in batches of 4096: update per batch, the 11
   full batches replayed as one captured CUDA graph, log_likelihood,
   predict_f and predict_uncertain per 256, downdate; float64 on the card
   against batch VFE on all the data, float32 against float64 with a TF32
   control that must fail; all under the fixed jitter policy.  OnlineSGPR
   at m = 1024: 4 steps of 60 Adam iterations in float64 under the "none"
   jitter policy (one captured graph per has_old, reused), predict_f; the
   same steps in float32 must go non-finite (the summary's 1e-10 floor is
   below float32's rounding); the exactness anchor (θ and Z fixed over the
   whole stream, float64) against batch VFE.
30. pathwise: pathwise_gpr_samples on the exact serving model (n = 32768,
   16 paths of 1024 features over 4096 candidates), pathwise_svgp_samples
   on the cell's SVGP; the iterative branch on phase 15's model (8 paths;
   K3 through the posterior's CG), run before that model is freed.
   Checks: the samples' moments against predict_f; in float64 at n = 512
   the card against the CPU with the draws held fixed.
   Phases 27-30 print the seconds they took together; the heteroscedastic
   SVGP, the deep GP, StreamingVFE, OnlineSGPR and the three samplers are
   each a path of their own.
31. bayesopt: the serving cell's posterior (n = 32768, d = 8, Rbf-ARD,
   Gaussian(0.1), float32) over the box [-3, 3]^8: score_candidates over
   4096 candidates for ei, logei, pi and ucb; suggest (4096 candidates, 25
   refinement steps, each a value-and-grad of predict_f at one point: K1's
   32768 × 1 cross Gram and its backward); suggest_thompson (q = 4, 1024
   features); suggest_qei (q = 4, 128 paths over 2048 candidates, 60
   steps); four Kriging-believer picks (suggest, then condition_on at the
   predicted mean); each with its ms, K1 launches and peak memory.  Checks:
   every point in the box; the suggestion's EI at least the best
   candidate's, or that candidate; float32 against float64 EI over the
   candidates; in float64 at n = 256 the card against the CPU (the CPU's
   draws replayed) for suggest, suggest_thompson and suggest_qei.
32. bayesopt_loop: BayesOpt(bounds=[[0, 1]] * 8, Rbf-ARD, fit_iters=200,
   refit_every=4, n_candidates=4096) on the Levy function, 512 seeded
   observations then 16 suggest/observe iterations and a batch of 4 by
   "ts", "believer" and "qei", float64 under the "none" jitter policy;
   then 4 iterations with the default Matern52 (no K1).  ms an iteration
   split into refits (capture and 200 captured Adam steps, the capture's
   share) and fantasy iterations (condition_on); K1 launches an iteration.
   Checks: best_y never rises; a fantasy posterior equals a fresh
   posterior() of the augmented data at the same hyperparameters; points in
   the box; every refit captured.
33. design on phase 31's posterior: suggest_batch q = 8 over the 4096
   candidates, "alc" with 1024 references and "variance"; ms a pick, the
   stages K(X, x_cand) and its 32768² × 4096 triangular solve against
   their bounds, peak memory.  Check: the first pick's ALC equals the
   variance drop over the references that condition_on realizes (float32
   at n = 32768, with a control that must fail; float64 at n = 4096).
34. metrics: kfold_cv with k = 5 on n = 5120 (make_data), Rbf-ARD,
   Gaussian(0.1), 100 captured Adam steps (one batched K1 launch of 5 ×
   4096² a step); its ms, the steps' ms an iteration, the capture; then
   summarize on phase 31's predictions of 8 × 256 queries.  Checks:
   finite fold metrics; in float64 at k = 3, n = 96 the card against the
   CPU.
35. structure and checkpoint: kernel_search at bench_ksearch.py's cell (n
   = 256, bases Rbf and Linear, depth 2, 40 L-BFGS iterations) and the
   default search (Rbf, Linear, Cosine; depth 3; 150 iterations) at n =
   1024: candidates a minute, the expression, L-BFGS evaluations, K1
   launches; in float64 the card's search against the CPU's.  Checkpoint
   round trips of the serving model, a StreamingVFE and an OnlineSGPR
   (phase 29's shapes); after load_trainable into a model whose captured
   fit_scan graph is cached, fit_scan replays it and gives a fresh model's
   losses.  profiling.trace around one serving predict_f names K1's kernel
   and an annotate("gram") range; device_memory_stats's peak is torch's
   (in a fresh process of the script, ``--profiling-check DIR``: after the
   earlier phases' profiler sessions a trace in this process holds no
   kernel records of a short window).
   Phases 31-35 print the seconds they took together; bayesopt,
   bayesopt_loop, design, metrics, kernel_search and checkpoint are each a
   path of their own.  K1 shapes whose n grows while a path runs (the loop,
   the believer picks, the design's conditioned posteriors) and those of
   the small float64 checks are held against the twin as they launch.
36. mcmc_example: examples/hyperparameter_mcmc.py:45-55's model, built by
   its twin examples_torch/hyperparameter_mcmc.py's make_model (n = 30,
   Matern52 with LogNormal(0, 1) priors on the variance and the length
   scale, Gaussian(0.1), float64), sample_posterior with 2 chains of 300
   warmup + 300 draws, 16 leapfrogs, under the fixed jitter policy (each
   transition one captured CUDA graph), held to the JAX test's assertions
   (accept > 0.6, no divergence, R-hat < 1.1, ESS > 100), then under the
   default adaptive one (eager: the probe reads the host; cut to 50 + 50);
   ms a transition, host reads a transition (none in the captured run:
   checked), accept rate, divergences, R-hat and ESS of the length scale;
   then predict_mixture over the captured run's 600 draws at 120 points.  No hand kernel runs
   here (Matern52's Gram is plain torch).
37. mcmc_nuts: the same model by NUTS (max depth 10, captured under the
   fixed policy): ms a transition, tree depths, host reads and leapfrogs a
   transition; held to test_nuts_sampler_matches_hmc's assertions against
   phase 36's draws.
38. mcmc_fused: Rbf-ARD (LogNormal(0, 1) priors), d = 8, at n = 4096 on
   bench.py's data, float32, on the fused path (K1 and K2 in every
   leapfrog, each chain through the fused loss's vmap rule), 2 chains of
   24 leapfrogs, captured.  At the model's own start (well conditioned),
   one chained value-and-grad timed, held to each chain evaluated alone
   outside vmap (the rule runs the same kernels on the same values:
   equal to 1e-5, with the two chains 100 times that apart) and to
   float64 (4·u·κ).  Then the MAP by 100 captured Adam steps, and from it
   warmup and draws sized to 30 s of sampling (the cut is printed): the
   launches a transition's graph recorded (K1 and K2 once per chain and
   leapfrog), accept > 0.6, no divergence, largest R-hat < 1.5 (a chain
   stranded at long length scales read 1.7e4), and float32 against
   float64 at the last draws (the gradient's gap relative to its data-fit
   and log-det halves, which cancel near a mode).  A witness: from the
   model's own start at seed 0, 6 warmup transitions and a draw on the
   fused path in float32 and float64 and on the generic path in float32.
39. mcmc_latent: sample_latent of a Bernoulli LaplaceGP (Rbf, x on a grid
   over [-2, 2], y = [sin 2x > 0]) at n = 4096, float32, 200 burn + 300
   draws (captured chunks of 8 shrinks), then predict_latent_mixture at
   256 points; ms and shrinks a transition beside the bound of reading the
   prior factor once; the draws' mean held to the Laplace mode (correlation
   > 0.99, the JAX test's assertion).
   Phases 36-39 print the seconds they took together; each is a path of
   its own in the kernels line.
40. examples: each twin of examples_torch/ (the fifteen scripts of
   examples/ but hyperparameter_mcmc, whose model phase 36 takes from its
   twin) through its main([..., "--device", "cuda", "--no-plot"]) in this
   process, at its JAX script's default arguments (the cuts, if any, in
   EX_CUTS are printed): its seconds, its summary numbers and its K1 and
   K2 launches (the counters over its own run plus the launches of the
   CUDA graphs it replays: fit_scan's captured steps, the served predict,
   the replayed stream), every K1 and K2 shape held against the plain
   twin as it launches unless the kernel phases cover it; the JAX test's
   assertions (its printed markers, the JAX mechanism's name replaced by
   the card's, and its numeric checks) and the scripts' own asserts.
   serving trains at n = 4096, where fit_scan's 60 captured steps run the
   fused NLML (K1 and K2 each step).  Then regression_1d (GPR and VFE) and
   serving at n = 512 in float64 on the card against the CPU, whose side a
   background process of this script (``--examples-cpu-reference PATH``)
   runs from the start of the zoo phases.  Each example is a path of its
   own in the kernels line.

On the card, fit_scan captures a first-order run as a CUDA graph; the
training, general-training, SVGP and DKL phases check that it did.  Before
each main path runs, every kernel's launch counter is set to 0; it is read
just after, and each kernel of the path must have launched.  A counter
counts launches made from the host, so a captured run's launches are
reckoned as the launches recorded in its captured step times the replays.
Any failed check exits non-zero.  Without a CUDA card it exits 2 and
prints no result.
Lines starting with "#" report each measurement; the line before the last
holds the per-kernel numbers as JSON; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import atexit
import contextlib
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}  # H100 SXM, outside the tensor cores
N, D, Q, BATCHES = 32768, 8, 256, 8
TOL = {"float32": 2e-5, "float64": 1e-12}  # kernel vs plain, absolute, per unit of var
# Serving (L⁻¹ products) vs the posterior's triangular solves, float32, in
# absolute units of the moments (both O(1) here): f32 roundoff (6e-8)
# amplified by cond(K) <= (n·E[k] + σ²)/σ² ≈ 2e4 for this data gives
# ~1.2e-3; the bound leaves a factor 4.
SERVING_TOL = 5e-3
F64_REL_TOL = 1e-8
# The training leg of bench.py:56-121.
TRAIN_NB, TRAIN_JITTER, TRAIN_LR, TRAIN_STEPS = 1024, 1e-3, 1e-4, 4
KINDS = ("rbf", "matern12", "matern32", "matern52", "rq")
# K2 vs its plain twin, relative to the sum of absolute terms of each output
# (contract.contraction_scales).  The kernel rounds each term (and W =
# dy·K⁻¹ − AAᵀ) once and sums a row's n terms in 32 lanes of n/32 sequential
# adds, the twin sums in cuBLAS's order: for rounding errors that behave as
# random, about √(n/32)·u of the scale (Higham, Accuracy and Stability of
# Numerical Algorithms, §4.2) -- 2e-6 in float32 at n = 32768, 3.5e-15 in
# float64.  float32 keeps a factor of ten.  In float64 the twin's own r² by
# the norm identity (error up to u·(|x̃ᵢ|² + |x̃ⱼ|²)), which matern12's
# E = G/r amplifies at the closest pair, sets the scale: 1e-10.  At n = 4096
# the float32 kernel is held against the twin in float64 on the same inputs,
# so the twin's float32 r² (the same amplification, at u = 6e-8) is not
# charged to the kernel.
CONTRACT_TOL = {"float32": 2e-5, "float64": 1e-10}
F32_UNIT_ROUNDOFF = 2.0 ** -24
# The sparse paths: bench_svgp.py:21-60's configuration (UCI-protein scale).
SP_N, SP_D, SP_M, SP_BATCH = 45730, 9, 1024, 4096
SP_STEPS, SP_LR, SP_JITTER = 50, 1e-2, 1e-6
SP_PROFILED_STEPS = SP_STEPS  # the timed call's length, so the profiled call replays the same graph
# The kernel-general training path: the reference example's composite at
# bench.py's scale, fit_scan Adam (warm call + timed call) then L-BFGS-B,
# then joint posterior samples.
GEN_STEPS, GEN_LBFGS_ITERS, GEN_SAMPLES = 2, 2, 64
# The observe loop at the serving cell: a chain with room for OBS_STEPS
# batches of OBS_NB points, then posterior function samples over
# PATH_CANDIDATES candidate inputs.
OBS_STEPS, OBS_NB = 32, 2
PATH_SAMPLES, PATH_FEATURES, PATH_CANDIDATES = 16, 1024, 4096
# Captured against eager: per-step losses of the SVGP cell (float32) within
# this relative difference (the eager loop's Adam keeps its step count on
# the host, the captured one on the card, so their bias corrections round
# apart), after the batches are checked identical; the exact training
# phase holds its captured losses to the eager ones at EXACT_CAPTURE_RTOL.
CAPTURE_RTOL, EXACT_CAPTURE_RTOL = 1e-5, 1e-6
# The kernel zoo on the kernel-general path (bench.py's data): L-BFGS
# iterations at n = 32768, and the float64 card-vs-CPU check at n = 4096
# (the loss and gradient, then the losses at the card's L-BFGS iterates,
# evaluated on the CPU by a background process of this script: one CPU
# evaluation there takes 15-40 s, and three L-BFGS iterations take 25 of
# them).  The card's side runs first in the zoo phases and the CPU's is
# collected beside the iterative check's, so that it overlaps the zoo's
# and the iterative phases' card work.
ZOO_LBFGS_ITERS, ZOO_CHECK_N, ZOO_CHECK_ITERS, ZOO_MIXTURES = 3, 4096, 3, 4
ZOO_PEAK_GB = 40.0
ZOO_GRAM_CHECK_N = 2048
# Deep kernel learning with a Student-t likelihood at the sparse cell:
# DeepKernel(Rbf(2, ARD), MLP([9, 64, 64, 2])) (gptorch_tpu/nn.py:67's widths).
DKL_WIDTHS, DKL_DF = [SP_D, 64, 64, 2], 4.0
DKL_CHECK_N, DKL_CHECK_M = 4096, 128
# The matrix-free exact GP: bench_iterative.py's model at bench.py's
# n = 100000 (bench.py:293-295): GPR(solver="iterative"), Rbf(8, ARD),
# Gaussian(0.1), 8 probes, 128 CG steps, a rank-64 preconditioner, CG
# tolerance 1e-4, jitter 1e-3, float32; two timed value-and-grads, then
# fit_scan Adam lr 1e-4 for 2 steps.  Serving: LOVE of rank 256, 8 batches
# of 256 queries; then one CG-exact predict_f of 16 queries.  The float64
# card-vs-CPU check runs at n = 4096 with LOVE of rank 64, and CG to 1e-10
# in up to IT_CHECK_ITERS steps, so that every column of both routes
# converges (they need about 160 steps there) and the solves, and all that
# is linear in them, agree to the check's 1e-8 whichever step each route
# stops on.
IT_N, IT_PROBES, IT_CG_ITERS, IT_RANK, IT_TOL, IT_SLAB, IT_JITTER = 100000, 8, 128, 64, 1e-4, 4096, 1e-3
IT_STEPS, IT_LOVE_RANK, IT_CG_QUERIES, IT_CHECK_N, IT_CHECK_LOVE = 2, 256, 16, 4096, 64
IT_CHECK_TOL, IT_CHECK_ITERS = 1e-10, 200
# K3 and K4 against their plain twins (run in float64 on the same inputs,
# so the twin's own rounding is not charged to the kernel), relative to the
# sums of absolute terms of each output (mvm.gram_mvm_plain on |V|;
# lowrank_contract.lowrank_scales).  float32: K3 sums a row's terms in one
# running float32 sum per thread and column range (as a GEMM does), then
# two warps' and the ranges' sums in order; K4 sums a work item's terms in
# float32 per thread (each unordered pair once: 128 columns against the
# thread's rows, four at d = 8, r = 9: 512 terms, each pair's weight
# Sᵢⱼ = Wᵢⱼ + Wⱼᵢ a float32 dot product of 2r terms), then in float64.
# For rounding errors that behave as random that is about √m·u of the
# scale for m terms, 3e-6 for K3 at n = 4097 (m ≈ n/2; Higham §4.2).  Each
# of K4's outputs sums all n²/2 terms, whose errors against the sum of
# their absolute values average down as 1/√m: about 1e-10 of the scale at
# n = 4096 on an H100.  K3's norm identity adds about
# u·(|x̃ᵢ|² + |x̃ⱼ|²)·|c| to each exponent on centred inputs (1e-6 relative
# at d = 8), and the approximate exp2, log2, rcp and sqrt about 2^-22 per
# term: 2e-5 keeps a factor of five.
# float64: summation (√n·u ≈ 1e-14) and the twin's r² by the norm identity
# (error up to u·(|x̃ᵢ|² + |x̃ⱼ|²)), which matern12's E = G/r amplifies at
# the closest pair, as for K2: 1e-10.
MVM_TOL = {"float32": 2e-5, "float64": 1e-10}
# K4 in float32 is also held to a limit that falls with its pair count m =
# n(n + 1)/2: 2e-5 of the scale would pass a kernel that wrote zeros at
# n = 100000, where each output (a random-signed sum, about 1/√m of its
# scale) is itself about 1e-5 of the scale.  Its errors behave as random
# and measure about 9e-7/√m of the scale (3.3e-10 at n = 4096, 1.1e-11 at
# n = 100000 on an H100); 1e-4/√m keeps a factor of about 100 over that and
# fails a zero output, a missed factor of two in Sᵢⱼ or one 128 × 128 tile
# left out at n = 100000.
LOWRANK_F32_RANDOM = 1e-4
# The ψ-statistics at bench_ekernels.py's cell (the reference's
# one published timing: n = 1000, m = 50, q = 10) and ψ₂ per datum at the
# sparse width (EK_QUERIES queries against m = 1024, q = 9).  float32 against
# float64, relative to each statistic's largest entry: an H100 reads 1.2e-7
# (ψ₁) and 1.9e-7 (ψ₂) on these seeded inputs; the limit keeps a factor of
# 20 over the worse.  Its control: ψ₂ with TF32 products allowed (the
# port pins them off) must fail it.
EK_N, EK_M, EK_Q, EK_QUERIES = 1000, 50, 10, 256
PSI_F32_TOL = 4e-6
# The Bayesian GPLVM at the oil-flow data's shape (Titsias & Lawrence 2010:
# 1000 × 12, Q = 10, M = 50) on synthetic data from a seed: fit_scan Adam
# (a warm and a timed call of GP_STEPS), project and impute of
# GP_PROJECT_ROWS rows by GP_PROJECT_ITERS Adam steps; the float64
# card-vs-CPU check at (n, p, q, m) = GP_CHECK.
GP_N, GP_P, GP_Q, GP_M, GP_STEPS, GP_LR = 1000, 12, 10, 50, 20, 1e-2
GP_PROJECT_ROWS, GP_PROJECT_ITERS, GP_CHECK = 16, 200, (40, 6, 3, 8)
# Uncertain-input prediction: the sparse cell's VFE and SVGP over Q queries,
# and GPR at n = 4096, d = 8 over 16 (its ψ₂ with Z = X is (n*, n, n)).
# VFE's and SVGP's moments at non-zero input variance for the first
# UP_CPU_QUERIES queries are held against float64 on the CPU: the card's
# float64 to F64_REL_TOL, its float32 to UP_F32_TOL of each output's
# largest entry (an H100 reads 3.5e-6 for VFE and 1.8e-6 for SVGP; the
# limit keeps a factor of 20 over the worse).  Its control: the float32
# moments with TF32 products allowed must fail it.
UP_GPR_N, UP_GPR_QUERIES, UP_CPU_QUERIES = 4096, 16, 16
UP_F32_TOL = 7e-5
# The Vecchia GP at bench_vecchia.py's cell: n = 200000, d = 3, m = 32,
# chunk 8192; fit_scan Adam VE_STEPS a call; full history against the dense
# GPR at VE_DENSE_N, the card against the CPU at VE_CHECK_N, both float64.
VE_N, VE_D, VE_M, VE_CHUNK, VE_STEPS, VE_DENSE_N, VE_CHECK_N = 200000, 3, 32, 8192, 3, 512, 4096
# float32 against float64 Vecchia NLML at VE_N, relative: an H100 reads
# 8.8e-10 on the seeded data with the neighbour Grams from K1 (direct
# differences; 5.7e-7 when they came from batched squared distances in
# torch ops); the limit keeps a factor of about 23.  Its control: the
# float32 NLML with the neighbour Grams rounded to float16 (TF32's 10-bit
# mantissa) must fail it.  The NLML with TF32 products allowed is printed
# beside it (it equals the pinned one on an H100).
VE_F32_TOL = 2e-8
# The state-space GP at bench_ssgp.py's cell: n = 65536 (bench.py:291-292)
# and bench_ssgp.py's default n = 10⁶ (the chunked scan, chunk 65536);
# fit_scan Adam SS_STEPS a call; SS_SAMPLES joint draws timed and
# SS_MOMENT_SAMPLES held by their moments; in float64 the card against the
# CPU at SS_CHECK_N (chunk SS_CHECK_CHUNK) and the dense GPR at SS_DENSE_N.
SS_N, SS_N_LONG, SS_STEPS, SS_SAMPLES, SS_MOMENT_SAMPLES = 65536, 1_000_000, 4, 16, 512
SS_CHECK_N, SS_CHECK_CHUNK, SS_DENSE_N = 4096, 1024, 2048
SS_KERNELS = ("matern12", "matern32", "matern52", "matern32+matern52")
# float32 against float64 NLML (relative) and gradient (over its largest
# entry), by n: an H100 reads 1.3e-7 and 9.8e-7 at SS_N, 5.9e-7 and
# 1.15e-4 at SS_N_LONG (a million float32 terms of both signs summed into
# each gradient entry); the limits keep a factor of about 20.
SS_F32_TOL = {SS_N: {"nlml": 3e-6, "grad": 2e-5}, SS_N_LONG: {"nlml": 1.2e-5, "grad": 2.5e-3}}
# The Kronecker grid GP on the JAX docstring's 64³ grid (models/kronecker.py:
# 14-15); diag=False at KR_FULL_QUERIES; the float64 check on KR_CHECK_SIZES.
KR_SIZE, KR_STEPS, KR_FULL_QUERIES, KR_CHECK_SIZES = 64, 4, 64, (16, 12, 10)
# SKI at bench_calibration.py:95-104's 3-D row, at bench.py's n = 100000
# (its test split gives the queries); the float64 check at SKI_CHECK_N.
SKI_N, SKI_GRID, SKI_CG_QUERIES, SKI_CHECK_N, SKI_CHECK_TOL, SKI_CHECK_ITERS = 100000, 16, 16, 2048, 1e-11, 400
# The fleet of exact GPs at bench_ensemble.py's cell: B = 256 members of
# n = 512 points, d = 4, Rbf-ARD, Adam at lr 0.05; EN_STEPS steps a fit_scan
# call; the float64 card-vs-CPU check at EN_CHECK_B members of EN_CHECK_N.
EN_B, EN_N, EN_D, EN_LR, EN_STEPS, EN_CHECK_B, EN_CHECK_N = 256, 512, 4, 0.05, 10, 4, 256
# ICM at n = 4096, d = 8 (bench.py's width), p = 4 outputs, rank 2; joint
# predictions at MO_JOINT queries; the float64 check at n = 512.  LMC at
# bench_svgp.py's cell (n = 45730, d = 9, m = 1024, batch 4096) with p = 4
# outputs mixed from L = 3 latent Rbf-ARD GPs by a seeded W; 50 captured
# Adam steps at lr 1e-2 and MO_NAT_STEPS natural steps; the float64 check
# at n = 2048, m = 64 on one explicit batch.
ICM_N, ICM_P, ICM_RANK, MO_JOINT, ICM_CHECK_N = 4096, 4, 2, 64, 512
LMC_L, MO_NAT_STEPS, MO_NAT_LR, LMC_CHECK_N, LMC_CHECK_M = 3, 5, 0.1, 2048, 64
# The derivative GP at n = 2048, d = 8 (a joint system of 18432²); the
# float64 check at n = 128, d = 3.
DG_N, DG_CHECK_N, DG_CHECK_D = 2048, 128, 3
# TPR and WarpedGPR (3 tanh terms) at bench.py's n = 32768, d = 8; the
# LaplaceGP (Bernoulli) at n = 8192, whose 20 differentiated Newton steps
# each keep n² tensors; float32 against float64 at half those n (a float64
# value-and-grad keeps several n² buffers: at n = 32768 each is 8.6 GB);
# the float64 card-vs-CPU checks at n = 512.
EV_N, EV_LAPLACE_N, EV_CHECK_N = 32768, 8192, 512
# The Laplace GP's float32 evidence and gradient against float64 at
# EV_LAPLACE_N / 2.  Its Newton steps choose their step size by the largest
# ψ on a grid; near the mode ψ changes by less than its float32 rounding,
# so the float32 mode is resolved only to about √u (u the unit roundoff)
# and the gradient through the steps with it: 4·u·κ does not hold here.
# An H100 reads 2.95e-6 (evidence) and 9.11e-5 (gradient) on the seeded
# data, the same in every run of this phase; the limits keep a factor of
# about 3.4.  The float32 run with TF32 products allowed, or with K1's
# Grams rounded to float16 or bfloat16, reads within 2x of the pinned run
# (the rounding averages out; the Newton steps' resolution sets the gap),
# so the control that must fail is the Grams off by 2⁻¹¹ in one direction.
LAPLACE_F32_TOL = {"loss": 1e-5, "grad": 3e-4}
# Slice 14 at bench_svgp.py's sparse cell (SP_*), float32.  The
# heteroscedastic SVGP on its inputs with y = sin(x₀) + e^{g/2}·ε, g = −4 +
# 2·tanh(x₁); the float64 card-vs-CPU check at HS_CHECK_N, HS_CHECK_M on one
# explicit batch of HS_CHECK_B.  The deep GP in Salimbeni & Deisenroth's
# UCI setup (M = 100 per layer, hidden width min(30, D) = 9, three layers,
# one sample in training, the full data): fit_scan Adam SP_STEPS a call,
# a value-and-grad on one explicit batch of DGP_BATCH, predict_f with
# DGP_PRED_SAMPLES passes, the launch check at DGP_LAUNCH_SAMPLES samples;
# the float64 card-vs-CPU check at DGP_CHECK_N (S = 2, draws held fixed).
HS_CHECK_N, HS_CHECK_M, HS_CHECK_B = 2048, 64, 512
# The heteroscedastic SVGP's float32 loss and gradient against float64 on
# one batch of SP_BATCH.  An H100 reads 6.6e-8 (loss) and 1.3e-7
# (gradient), the same in every run of this phase.  Its controls, at the
# float32 model's values against the same float64 run, each fail both
# limits: the float32 run with TF32 products allowed reads 7.1e-7 and
# 1.0e-5, with K1's Grams scaled by 1 + 2⁻¹¹ 1.6e-4 and 1.6e-4.  The
# limits sit between: about 6× and 16× the readings, under the TF32
# control by 1.8× and 5×.
HS_F32_TOL = {"loss": 4e-7, "grad": 2e-6}
DGP_M, DGP_WIDTHS, DGP_BATCH, DGP_PRED_SAMPLES, DGP_LAUNCH_SAMPLES, DGP_CHECK_N = 100, (9, 9), 10000, 20, 4, 512
# StreamingVFE with its hyperparameters fixed by a seeded setting
# (ekernels.Rbf(9, ARD) with length scales linspace(0.8, 1.6), variance 1,
# Gaussian(ST_NOISE): the data's own noise), streaming the cell's n in
# batches of SP_BATCH (11 full ones, then the rest), the 11 full ones also
# as one captured CUDA graph, under the cell's fixed jitter policy.
# OnlineSGPR at m = 1024: ON_BATCHES steps of ON_ITERS Adam iterations (lr
# ON_LR), captured, in float64, under the "none" jitter policy: the fixed
# policy's relative jitter on the factor of S_a lifts S_a above V_aa in
# Kuu's near-null directions once θ has trained, and chol(V_aa − S_a) is
# then NaN in float64 too (the same code in the JAX package).  In float32
# the 1e-10 floor on V_aa − S_a lies below the rounding and the steps go
# non-finite at this cell (ROADMAP §3), which the phase checks: the same
# steps in float32 must fail.  The exactness anchor (θ and Z fixed) over the whole stream in
# float64 with jitter ON_ANCHOR_JITTER, also under "none" (the fixed
# policy's jitter on every factor would break the identity with batch VFE).
ST_NOISE, ON_BATCHES, ON_ITERS, ON_LR, ON_ANCHOR_JITTER = 0.01, 4, 60, 0.05, 1e-9
# The pathwise samplers: PW_SAMPLES paths of PW_FEATURES features over
# PATH_CANDIDATES candidates (the exact serving model, n = 32768, d = 8;
# the sparse cell's SVGP), PW_IT_SAMPLES on phase 15's matrix-free model;
# the float64 card-vs-CPU check at PW_CHECK_N with the draws held fixed.
PW_SAMPLES, PW_FEATURES, PW_IT_SAMPLES, PW_CHECK_N = 16, 1024, 8, 512
# The application layer (phases 31-35).  bayesopt: the serving cell's
# posterior (n = 32768, d = 8, float32) over the box [-BO_BOX, BO_BOX]^8
# (its inputs are N(0, I)): BO_CANDIDATES candidates and BO_STEPS
# refinement steps a suggest, Thompson with BO_TS_Q paths, q-EI with
# BO_QEI_Q points, BO_QEI_SAMPLES paths over BO_QEI_CANDIDATES candidates
# and BO_QEI_STEPS steps, BO_BELIEVER believer picks; the card against the
# CPU in float64 at BO_CHECK_N.  float32 against float64 EI over the
# candidates, absolute in y's units: the serving phase's SERVING_TOL, the
# moments' own float32 limit on this data.
BO_BOX, BO_CANDIDATES, BO_STEPS, BO_TS_Q, BO_FEATURES, BO_CHECK_N = 3.0, 4096, 25, 4, 1024, 256
BO_QEI_Q, BO_QEI_SAMPLES, BO_QEI_CANDIDATES, BO_QEI_STEPS, BO_BELIEVER = 4, 128, 2048, 60, 4
# bayesopt_loop: BayesOpt on [0, 1]^8 over the Levy function (mapped from
# [-10, 10]^8), LOOP_N0 seeded observations, LOOP_ITERS suggest/observe
# iterations (Rbf-ARD, LOOP_FIT_ITERS Adam steps a refit, refit every
# LOOP_REFIT observations), a batch of LOOP_BATCH per strategy, then
# LOOP_MATERN_ITERS iterations with the default Matern52.  In float64: the
# surrogate's noise starts at 1e-4 of the standardized targets, so K + σ²I
# has κ ~ n/σ² ~ 5e6 and float32's factors keep about one digit.  Under
# the "none" jitter policy (which, like "fixed", lets fit_scan capture):
# "fixed" jitters the fantasy rows' Schur complement by 1e-6 of its own
# small diagonal and a fresh factor by 1e-6 of K's, so the two would factor
# different matrices.  The fantasy posterior against a fresh factorization
# of the augmented data: LOOP_FANTASY_TOL of the largest moment.
LOOP_N0, LOOP_ITERS, LOOP_FIT_ITERS, LOOP_REFIT, LOOP_BATCH, LOOP_MATERN_ITERS = 512, 16, 200, 4, 4, 4
LOOP_FANTASY_TOL = 1e-7
# design: DE_Q greedy picks over the BO_CANDIDATES candidates with DE_REF
# references, on phase 31's posterior.  The first pick's ALC against the
# variance drop over the references that condition_on realizes, relative:
# DE_F32_TOL in float32, about 20× an H100's reading of 1.8e-6; its
# control, ALC with every Rbf Gram scaled by 1 + 2^-11 (a kernel that
# misread its variance by half a float16 step), reads 9.5e-4 and must fail
# it.  DE_F64_TOL in float64 at DE_F64_N.
DE_Q, DE_REF, DE_F32_TOL, DE_F64_TOL, DE_F64_N = 8, 1024, 4e-5, 1e-8, 4096
# metrics: kfold_cv at CV_K folds of CV_N rows (make_data, d = 8, Gaussian
# noise 0.1 as the serving cell's), CV_ITERS captured Adam steps at lr
# CV_LR; the card against the CPU in float64 at CV_CHECK_K folds of
# CV_CHECK_N rows and CV_CHECK_ITERS steps.
CV_K, CV_N, CV_ITERS, CV_LR, CV_CHECK_K, CV_CHECK_N, CV_CHECK_ITERS = 5, 5120, 100, 0.05, 3, 96, 20
# structure: bench_ksearch.py's cell (n = KS_N, 1-D, RandomState(1),
# bases Rbf and Linear, depth 2, KS_ITERS L-BFGS iterations, float32 as
# the bench casts it), then the default search (Rbf, Linear, Cosine; depth
# 3; KS_DEFAULT_ITERS) at KS_DEFAULT_N in float64, the search's own advice
# ("same f64 numerics", gptorch_tpu/structure.py:182-183): in float32 the
# line search exhausts its 20 steps once the loss stops moving in float32's
# last digit (12-15 evaluations an iteration on an H100, 126 s for the
# default search); float64 card against CPU scores to KS_REL_TOL.  checkpoint:
# CK_STEPS Adam steps of the serving cell's model after load_trainable.
KS_N, KS_ITERS, KS_DEFAULT_N, KS_DEFAULT_ITERS, KS_REL_TOL, CK_STEPS = 256, 40, 1024, 150, 1e-6, 2
# A round trip recomputes from the same values in the same process, so its
# gaps are those of two runs of one computation: relative, CK_F32_TOL in
# float32 (the fused training step's reductions may differ in order from
# run to run), CK_F64_TOL in float64.
CK_F32_TOL, CK_F64_TOL = 1e-6, 1e-12
# mcmc: the model of examples/hyperparameter_mcmc.py:45-55 (n = MC_EX_N,
# Matern52 with LogNormal(0, 1) priors, Gaussian(0.1), float64), MC_CHAINS
# chains of MC_WARM + MC_DRAWS transitions of MC_LEAPFROG leapfrogs, by
# HMC captured (the fixed jitter policy) and eagerly (the default adaptive
# one; cut to MC_EAGER + MC_EAGER transitions: host-bound at 150-220 ms a
# transition on an H100's host, the full 600 took 91-134 s), then NUTS
# (max depth MC_NUTS_DEPTH), predict_mixture at MC_EX_QUERIES points; the
# fused path (Rbf-ARD, d = 8, n = MC_FUSED_N, float32, the JAX default's
# MC_FUSED_LEAPFROG leapfrogs): the vmap rule against each chain alone to
# MC_FUSED_RULE_TOL at the model's start, the MAP by MC_FUSED_FIT_STEPS
# captured Adam steps at MC_FUSED_FIT_LR, from it warmup and draws sized to
# MC_FUSED_SECONDS of sampling from one timed value-and-grad, the largest
# R-hat below MC_FUSED_RHAT (a chain stranded at long length scales read
# 1.7e4 on an H100), and the witness's MC_WITNESS_WARM warmup transitions
# from the model's start; sample_latent of a Bernoulli LaplaceGP at n =
# MC_LATENT_N (MC_LATENT_BURN + MC_LATENT_DRAWS) and
# predict_latent_mixture at MC_LATENT_QUERIES points.
MC_EX_N, MC_CHAINS, MC_WARM, MC_DRAWS, MC_LEAPFROG, MC_NUTS_DEPTH, MC_EX_QUERIES = 30, 2, 300, 300, 16, 10, 120
MC_EAGER = 50
MC_FUSED_N, MC_FUSED_LEAPFROG, MC_FUSED_SECONDS = 4096, 24, 30.0
MC_FUSED_FIT_STEPS, MC_FUSED_FIT_LR, MC_FUSED_RULE_TOL, MC_FUSED_RHAT, MC_WITNESS_WARM = 100, 0.1, 1e-5, 1.5, 6
MC_LATENT_N, MC_LATENT_BURN, MC_LATENT_DRAWS, MC_LATENT_QUERIES = 4096, 200, 300, 256

# The examples group: every twin of examples_torch/ in process on the card
# through main([..., "--device", "cuda", "--no-plot"]) at its JAX script's
# default arguments (the scripts' full width) and the default dtype
# (float32; kernel_discovery sets float64 as its JAX script does), except
# the cuts in EX_CUTS; hyperparameter_mcmc runs as phase 36.  A case is
# (the twin's name and what tells its runs apart, its arguments,
# tests/test_examples.py's markers); a JAX mechanism's name in a marker is
# replaced by the card's counterpart (EX_REPLACED).  The Matern kernels of
# timeseries_statespace and of BayesOpt's default surrogate launch no K1.
EX_CASES = [
    ("regression_1d GPR", ["--model-type", "GPR"], ["predictive mean range"]),
    ("regression_1d VFE", ["--model-type", "VFE"], ["predictive mean range"]),
    ("serving", [], ["exported serving posterior", "serve (mean only)"]),
    ("classification_1d", [], ["train accuracy"]),
    ("multiclass_1d", [], ["train accuracy"]),
    ("svgp_natgrad", [], ["serving: predict_y"]),
    ("heteroscedastic", [], ["noise-profile correlation"]),
    ("classification_laplace", [], ["Laplace evidence", "train accuracy"]),
    ("derivative_gp", [], ["improvement factor"]),
    ("multioutput", [], ["LMC mixing ratio"]),
    ("timeseries_statespace", [], ["dense GPR NLML", "rel diff"]),
    ("streaming_gp", [], ["restart fleet", "one compiled program"]),
    ("active_learning", [], ["ALC beats random: True"]),
    ("bayesopt_loop", [], ["regret", "parallel proposals"]),
    ("kernel_discovery", [], ["discovered kernel: (Rbf + Linear)"]),
]
# heteroscedastic's 4000 Adam steps for each of its two SVGPs run eagerly
# under the default adaptive jitter policy (its probe reads the host), 9 ms
# a step on an H100's host: 72.7 s at the defaults, half the group's time.
EX_CUTS = {"heteroscedastic": ["--steps", "1000"]}
EX_REPLACED = {"one compiled program": "one captured CUDA graph"}
EX_NO_K1 = {"timeseries_statespace", "bayesopt_loop"}
# The card against the CPU, both in float64: regression_1d (GPR and VFE)
# and serving at n = 512, the CPU side run by a background process of this
# script (``--examples-cpu-reference PATH``) started with the zoo phases.
# Each output (the predictive moments, the final loss, the losses) is held
# relative to its largest entry to its limit here; the random draws are
# not compared (two generators).  GPR's and serving's outputs read 4.2e-12
# and 1.8e-13 on an H100 (1e-9 keeps a factor of over 200).  VFE's 100
# L-BFGS-B iterations end where the path takes them: the CPU reference
# also reruns regression_1d with its inputs scaled by 1 + EX_SCALE and
# prints how far that moves each output on the CPU alone (VFE's mean
# 7.2e-5, its variances 4.8e-4, its loss 1.8e-8; GPR's 1.3e-12), and the
# card read 2.2e-5 and 4.0e-4; so VFE is held to the loss it reaches
# (1e-6) and its moments to 2e-3, about four times that spread.
EX_SCALE = 1e-14
EX_CHECK = [
    ("regression_1d GPR", ["--model-type", "GPR"], {"mean": 1e-9, "var": 1e-9, "loss": 1e-9}),
    ("regression_1d VFE", ["--model-type", "VFE"], {"mean": 2e-3, "var": 2e-3, "loss": 1e-6}),
    ("serving n=512", ["--n", "512", "--queries", "32"], {"losses": 1e-9, "mu": 1e-9, "var": 1e-9, "mean_only": 1e-9}),
]


def lowrank_tol(name, n):
    """K4's limit against its twin, relative to lowrank_scales: MVM_TOL,
    and in float32 also LOWRANK_F32_RANDOM/√(n(n + 1)/2)."""
    if name == "float64":
        return MVM_TOL[name]
    return min(MVM_TOL[name], LOWRANK_F32_RANDOM / math.sqrt(n * (n + 1) / 2))


# Kuu's relative floor for 1024 inducing points seen through a 2-D feature
# map: their Rbf Gram has a numerical rank far below 1024, and float32's
# Cholesky needs a floor near 1e-3 where the sparse cell's 9-D inputs take
# 1e-6.  The model is built under the adaptive policy (the start of q(u)
# factors a rank-100 posterior covariance, escalating its jitter as
# needed) and trained under the fixed one, which a captured step can hold.
DKL_JITTER = 1e-3


class CheckFailed(Exception):
    pass


def check(ok, what):
    if not ok:
        raise CheckFailed(what)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0] if out else "unknown"


def time_ms(fn, reps):
    """Mean milliseconds per call of ``fn`` over ``reps`` warm calls (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, launches, replays=3):
    """Milliseconds the card spends on one call of ``fn``: ``launches`` calls
    captured in one CUDA graph, the graph replayed once warm, then
    ``replays`` times between two CUDA events.  The host's time to issue a
    call is left out; :func:`time_ms`'s loop of calls includes it (a small
    kernel's call reading is the host's)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (replays * launches)


def bound_ms(bytes_moved, ops, dtype):
    """The larger of the bytes over the memory rate and the operations over
    the peak rate (``dtype`` names the type), in ms, and which of the two
    it is."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def gram_bound_ms(n1, n2, d, sym, dtype, itemsize, batch=1):
    """Least time for ``batch`` radial Grams: each member's inputs and its
    two scalars read once, its output written once; 3d + 3 operations per
    output (d differences, d fused multiply-adds counted as two, the scale,
    the exp, the variance)."""
    bytes_moved = batch * ((n1 if sym else n1 + n2) * d + 2 + n1 * n2) * itemsize
    return bound_ms(bytes_moved, batch * n1 * n2 * (3 * d + 3), dtype)


def contract_bytes(n, d, dy, itemsize):
    """Bytes the backward contraction must move: K⁻¹, A, x̃ and the two
    scalars read once, rowsum, MX and the two sums written once."""
    return (n * n + n * dy + n * d + 2 + n + n * d + 2) * itemsize


def contract_bound_ms(n, d, dy, dtype, itemsize):
    """Least time for the rbf backward contraction: its bytes, and
    5d + 2dy + 8 operations per (i, j): r² (d differences, d fused
    multiply-adds), W (a scale, dy fused multiply-adds), G (scale, exp,
    variance), the svar fused multiply-add, W·E, the row sum, and d fused
    multiply-adds into MX, a fused multiply-add counted as two."""
    return bound_ms(contract_bytes(n, d, dy, itemsize), n * n * (5 * d + 2 * dy + 8), dtype)


@contextlib.contextmanager
def default_dtype(torch, dtype):
    old = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        yield
    finally:
        torch.set_default_dtype(old)


def dtype_name(dtype):
    return str(dtype).replace("torch.", "")


# K1's cases against its twin, (label, n1, n2, symmetric, d, noise on the
# diagonal), each in float32 and float64: the exact-GP shapes; the sparse
# paths' at d = 9 (Kuu symmetric with no added diagonal, Kuf of one batch,
# Kus of one query batch, a ragged pair); then every shape that the
# GPLVM and uncertain-prediction paths launch (checked by
# check_gram_coverage): the GPLVM's Kuu, K(Z, latents) and K(Z, queries)
# at q = 10; VFE's Kuf over all n; SVGP's start of q(u) from an exact GP
# on 100 points; GPR's K(X, X) and K(X, queries) at n = 4096; the grid
# GP's axis Grams (64², d = 1) and cross Grams of 256 and 64 queries; the
# single Grams of phases 23-26 (a fleet member alone, ICM, the derivative
# GP's value block, the Laplace GP, TPR at half n); phases 27-30's: the
# deep GP's first layer K(Z, X) (all n, a batch, queries), StreamingVFE's
# last short batch, K(x*, Z) of the streaming models' predictions and
# OnlineSGPR's K(Z, Z_old), and the samplers' K(x*, X) and K(x*, Z); phases
# 31-35's: the candidates' and a refinement point's K(X, ·), the paths at
# the q points and at q-EI's candidates, the design's references, the
# kernel search's Grams.  Shapes whose n grows as a path runs (the BayesOpt
# loop, the believer picks, the design's conditioned posteriors) and the
# small float64 checks' are held against the twin as they launch
# (held_gram_launches).
GRAM_CASES = [
    ("sym+diag", N, N, True, D, True),
    ("cross", N, Q, False, D, False),
    ("cross", Q, N, False, D, False),
    ("ragged", 4099, 1031, False, D, False),
    ("Kuu sym", SP_M, SP_M, True, SP_D, False),
    ("Kuf", SP_M, SP_BATCH, False, SP_D, False),
    ("Kus", SP_M, Q, False, SP_D, False),
    ("ragged", 1000, 4000, False, SP_D, False),
    ("lvm Kuu", GP_M, GP_M, True, GP_Q, False),
    ("lvm Kuf", GP_M, GP_N, False, GP_Q, False),
    ("lvm Kus", GP_M, Q, False, GP_Q, False),
    ("Kuf all", SP_M, SP_N, False, SP_D, False),
    ("q(u) K", 100, 100, True, SP_D, True),
    ("q(u) Kz", 100, SP_M, False, SP_D, False),
    ("gpr K", UP_GPR_N, UP_GPR_N, True, D, False),
    ("gpr Ks", UP_GPR_N, UP_GPR_QUERIES, False, D, False),
    ("grid K", KR_SIZE, KR_SIZE, True, 1, False),
    ("grid Ks", Q, KR_SIZE, False, 1, False),
    ("grid Ks full", KR_FULL_QUERIES, KR_SIZE, False, 1, False),
    ("member K", EN_N, EN_N, True, EN_D, True),
    ("icm Ks", Q, ICM_N, False, D, False),
    ("icm joint Ks", MO_JOINT, ICM_N, False, D, False),
    ("icm joint Kss", MO_JOINT, MO_JOINT, True, D, False),
    ("dgp K", DG_N, DG_N, True, D, False),
    ("dgp Ks", Q, DG_N, False, D, False),
    ("laplace K", EV_LAPLACE_N, EV_LAPLACE_N, True, D, False),
    ("laplace Ks", EV_LAPLACE_N, Q, False, D, False),
    ("half K", EV_N // 2, EV_N // 2, True, D, True),
    ("dgp K0", DGP_M, SP_N, False, SP_D, False),
    ("dgp K0 batch", DGP_M, DGP_BATCH, False, SP_D, False),
    ("dgp K0 query", DGP_M, Q, False, SP_D, False),
    ("Kuf tail", SP_M, SP_N % SP_BATCH, False, SP_D, False),
    ("Ksu", Q, SP_M, False, SP_D, False),
    ("Kzz old", SP_M, SP_M, False, SP_D, False),
    ("path Ksx", PATH_CANDIDATES, N, False, D, False),
    ("path Ksz", PATH_CANDIDATES, SP_M, False, SP_D, False),
    ("path Ksx it", PATH_CANDIDATES, IT_N, False, D, False),
    ("bo Kxc", N, BO_CANDIDATES, False, D, False),
    ("bo Kxq", N, 1, False, D, False),
    ("bo paths", BO_TS_Q, N, False, D, False),
    ("qei Kcx", BO_QEI_CANDIDATES, N, False, D, False),
    ("de Kxr", N, DE_REF, False, D, False),
    ("de Krc", DE_REF, BO_CANDIDATES, False, D, False),
    ("ks K", KS_N, KS_N, True, 1, True),
    ("ks K default", KS_DEFAULT_N, KS_DEFAULT_N, True, 1, True),
]
# K1's batched cases, (label, B, n1, n2, symmetric, d, noise on the
# diagonal), with a var and a diag of each member's own: the fleet's Grams
# with its noise, and its cross Grams against shared queries; the Vecchia
# path's neighbour Grams and cross columns of a full chunk, of the last
# chunk (n = 200000 leaves 3392 rows) and of a query batch; the deep GP's
# hidden layers' K(Z, F) over their samples (all n, a batch at S = 1 and
# 4, the 20 samples of predict_f); the k-fold fleet's training Grams and
# its held-out cross Grams.
GRAM_BATCHED_CASES = [
    ("fleet K", EN_B, EN_N, EN_N, True, EN_D, True),
    ("fleet Ks", EN_B, EN_N, Q, False, EN_D, False),
    ("ve Knn", VE_CHUNK, VE_M, VE_M, True, VE_D, False),
    ("ve k", VE_CHUNK, VE_M, 1, False, VE_D, False),
    ("ve Knn last", VE_N % VE_CHUNK, VE_M, VE_M, True, VE_D, False),
    ("ve k last", VE_N % VE_CHUNK, VE_M, 1, False, VE_D, False),
    ("ve Knn query", Q, VE_M, VE_M, True, VE_D, False),
    ("ve k query", Q, VE_M, 1, False, VE_D, False),
    ("dgp Kzf", 1, DGP_M, SP_N, False, SP_D, False),
    ("dgp Kzf batch", 1, DGP_M, DGP_BATCH, False, SP_D, False),
    ("dgp Kzf S", DGP_LAUNCH_SAMPLES, DGP_M, DGP_BATCH, False, SP_D, False),
    ("dgp Kzf query", DGP_PRED_SAMPLES, DGP_M, Q, False, SP_D, False),
    ("cv K", CV_K, CV_N - CV_N // CV_K, CV_N - CV_N // CV_K, True, D, True),
    ("cv Ks", CV_K, CV_N - CV_N // CV_K, CV_N // CV_K, False, D, False),
]


@contextlib.contextmanager
def tf32_allowed(torch):
    """Float32 matrix products on TF32 tensor cores inside the block, which
    the port pins off: the control run that a float32 limit must fail."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


@contextlib.contextmanager
def f16_neighbour_grams():
    """The Vecchia neighbour Grams rounded to float16 (the 10-bit mantissa
    of TF32) inside the block: the control run that the float32 NLML's
    limit must fail."""
    from gptorch_tpu_torch.ops import vecchia as vops

    batched_gram = vops.batched_gram
    vops.batched_gram = lambda kernel, a, b=None: batched_gram(kernel, a, b).half().to(a.dtype)
    try:
        yield
    finally:
        vops.batched_gram = batched_gram


@contextlib.contextmanager
def vmapped_neighbour_grams(torch):
    """The Vecchia neighbour Grams of every kernel, an Rbf's too, mapped by
    ``torch.func.vmap`` inside the block: the yardstick of
    ops.vecchia.batched_gram's route for an Rbf (its own ``K`` on the
    batch)."""
    from gptorch_tpu_torch.ops import vecchia as vops

    batched_gram = vops.batched_gram
    vops.batched_gram = lambda kernel, a, b=None: torch.func.vmap(kernel.K)(*((a,) if b is None else (a, b)))
    try:
        yield
    finally:
        vops.batched_gram = batched_gram


@contextlib.contextmanager
def rounded_rbf_grams(torch, dtype):
    """Every Rbf Gram (K1's output) rounded to ``dtype`` (float16: the
    10-bit mantissa of TF32; bfloat16: 7 bits) inside the block: two of the
    Laplace GP's control runs."""
    from gptorch_tpu_torch import kernels

    rbf_gram = kernels.rbf_gram
    kernels.rbf_gram = lambda *args, **kw: rbf_gram(*args, **kw).to(dtype).to(args[0].dtype)
    try:
        yield
    finally:
        kernels.rbf_gram = rbf_gram


@contextlib.contextmanager
def scaled_rbf_grams(factor):
    """Every Rbf Gram (K1's output) times ``factor`` inside the block: for
    1 + 2⁻¹¹, half a float16 step in one direction (a kernel that misread
    its variance by that much), the Laplace GP's control that its float32
    limits must fail."""
    from gptorch_tpu_torch import kernels

    rbf_gram = kernels.rbf_gram
    kernels.rbf_gram = lambda *args, **kw: rbf_gram(*args, **kw) * factor
    try:
        yield
    finally:
        kernels.rbf_gram = rbf_gram


@contextlib.contextmanager
def gram_launch_shapes():
    """Records (n1, n2, symmetric, d, batch, dtype) of every K1 launch made
    inside the block into the set it yields (batch None for one Gram)."""
    from gptorch_tpu_torch.ops import gram

    shapes, launch = set(), gram._launch

    def recorded(x1, x2, var, diag):
        n2 = x1.shape[-2] if x2 is None else x2.shape[-2]
        batch = x1.shape[0] if x1.ndim == 3 else None
        shapes.add((x1.shape[-2], n2, x2 is None, x1.shape[-1], batch, dtype_name(x1.dtype)))
        return launch(x1, x2, var, diag)

    gram._launch = recorded
    try:
        yield shapes
    finally:
        gram._launch = launch


def check_gram_coverage(shapes):
    """Fails unless each K1 shape of ``shapes`` (see gram_launch_shapes) is
    one of GRAM_CASES or GRAM_BATCHED_CASES, which gram_phase holds against
    the twin in both dtypes."""
    covered = {(n1, n2, sym, d, None) for _, n1, n2, sym, d, _ in GRAM_CASES}
    covered |= {(n1, n2, sym, d, b) for _, b, n1, n2, sym, d, _ in GRAM_BATCHED_CASES}
    missing = sorted((s for s in shapes if s[:5] not in covered), key=str)
    print(f"# rbf_gram shapes launched on the new paths: {sorted(shapes, key=str)}; not among gram_phase's cases: "
          f"{missing}", flush=True)
    check(not missing, f"rbf_gram shapes not held against the twin: {missing}")


def symmetric_gram_checks(torch, k, diagonal, what):
    """A symmetric Gram ``k`` (one or a batch) from K1: bitwise symmetric,
    and its diagonal exactly ``diagonal`` (var, plus diag where given: r² =
    0 there)."""
    check(torch.equal(k, k.mT), f"rbf_gram {what}: the symmetric Gram is not bitwise symmetric")
    want = diagonal[..., None].expand(k.shape[:-1])
    check(torch.equal(k.diagonal(dim1=-2, dim2=-1), want), f"rbf_gram {what}: the diagonal is not var (+ diag)")


def gram_batched_phase(torch, gram):
    """K1's batched launch against the twin, float32 and float64, with
    distinct var and diag per member (a kernel that read member 0's scalars
    would fail), timed beside the twin and its bound (the call from the
    host and the card's time alone, :func:`device_ms`); and one launch for
    the whole batch."""
    rows = []
    for dtype in (torch.float32, torch.float64):
        name = dtype_name(dtype)
        gen = torch.Generator(device="cuda").manual_seed(4321)
        for label, b, n1, n2, sym, d, noise in GRAM_BATCHED_CASES:
            x1 = torch.randn(b, n1, d, generator=gen, device="cuda", dtype=dtype)
            x2 = None if sym else torch.randn(b, n2, d, generator=gen, device="cuda", dtype=dtype)
            var = torch.rand(b, generator=gen, device="cuda", dtype=dtype) + 0.5
            diag = torch.rand(b, generator=gen, device="cuda", dtype=dtype) * 0.1 + 0.01 if noise else None
            with torch.no_grad():
                before = gram.rbf_gram.launches
                k = gram.rbf_gram(x1, x2, var=var, diag=diag)
                launches = gram.rbf_gram.launches - before
                torch.cuda.synchronize()
                p = gram.rbf_gram_plain(x1, x2, var, diag)
                err = float(((k - p).abs().amax(dim=(1, 2)) / var).max())
                del p
                call = lambda: gram.rbf_gram(x1, x2, var=var, diag=diag)  # noqa: E731
                if sym:
                    symmetric_gram_checks(torch, k, var + diag if noise else var, f"{label} {name}")
                del k
                ms = time_ms(call, 50)
                dev_ms = device_ms(call, 50)
                plain_ms = time_ms(lambda: gram.rbf_gram_plain(x1, x2, var, diag), 20)
            torch.cuda.empty_cache()
            bound, bound_by = gram_bound_ms(n1, n2, d, sym, name, x1.element_size(), batch=b)
            tol = TOL[name] * 1.3
            print(f"# kernel rbf_gram {label:8s} {name} batch {b} x ({n1}, {n2}) d={d}, a var and diag per member: "
                  f"max|kernel-plain|/var={err:.3e} (tol {tol:.1e}) in {launches} launch, call {ms:.4f} ms, "
                  f"device {dev_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({bound_by})",
                  flush=True)
            check(err <= tol, f"rbf_gram {label} {name} batch {b} error {err} > {tol}")
            check(launches == 1, f"rbf_gram {label}: {launches} launches for one batch")
            rows.append({"case": label, "dtype": name, "batch": b, "n1": n1, "n2": n2, "d": d, "max_abs_err": err,
                         "tol": tol, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound,
                         "bound_by": bound_by})
    return rows


def gram_phase(torch, gram):
    """K1 at every GRAM_CASES shape against the twin, float32 and float64,
    with the call's time from the host, the card's time alone
    (:func:`device_ms`), the twin's and the bound; then its backward and
    the batched cases."""
    rows = []
    for dtype in (torch.float32, torch.float64):
        name = dtype_name(dtype)
        gen = torch.Generator(device="cuda").manual_seed(1234)
        for label, n1, n2, sym, d, noise in GRAM_CASES:
            ell = torch.rand(d, generator=gen, device="cuda", dtype=dtype) + 0.5
            x1 = (torch.randn(n1, d, generator=gen, device="cuda", dtype=dtype) / ell).contiguous()
            x2 = None if sym else (torch.randn(n2, d, generator=gen, device="cuda", dtype=dtype) / ell).contiguous()
            var = torch.full((), 1.3, device="cuda", dtype=dtype)
            diag = torch.full((), 0.1, device="cuda", dtype=dtype) if noise else None
            with torch.no_grad():
                k = gram.rbf_gram(x1, x2, var=var, diag=diag)
                torch.cuda.synchronize()
                p = gram.rbf_gram_plain(x1, x2, var, diag)
                err = float((k - p).abs().max())
                del p
                call = lambda: gram.rbf_gram(x1, x2, var=var, diag=diag)  # noqa: E731
                if sym:
                    symmetric_gram_checks(torch, k, var + diag if noise else var, f"{label} {name}")
                del k
                big = n1 * n2 >= N * N
                ms = time_ms(call, 10 if big else 50)
                dev_ms = device_ms(call, 20 if big else 50)
                plain_ms = time_ms(lambda: gram.rbf_gram_plain(x1, x2, var, diag), 3 if big else 20)
            torch.cuda.empty_cache()
            bound, bound_by = gram_bound_ms(n1, n2, d, sym, name, x1.element_size())
            tol = TOL[name] * 1.3
            row = {
                "case": label, "dtype": name, "n1": n1, "n2": n2, "d": d,
                "max_abs_err": err, "tol": tol, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": bound_by,
            }
            print(f"# kernel rbf_gram {label:8s} {name} ({n1}, {n2}) d={d}: "
                  f"max|kernel-plain|={err:.3e} (tol {tol:.1e}) call {ms:.4f} ms, device {dev_ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({bound_by})", flush=True)
            check(err <= tol, f"rbf_gram {label} {name} ({n1},{n2}) error {err} > {tol}")
            rows.append(row)
    rows.append(gram_backward_check(torch, gram))
    rows.extend(gram_batched_phase(torch, gram))
    return rows


def gram_backward_check(torch, gram):
    """K1's backward (torch ops on the kernel's output) against autograd
    through the plain twin, float64, symmetric with noise and cross, at the
    n = 4096 card-vs-CPU shape of the generic path."""
    gen = torch.Generator(device="cuda").manual_seed(99)
    worst = 0.0
    for sym in (True, False):
        leaves = [
            torch.randn(4096, D, generator=gen, device="cuda", dtype=torch.float64),
            None if sym else torch.randn(Q, D, generator=gen, device="cuda", dtype=torch.float64),
            torch.tensor(1.3, device="cuda", dtype=torch.float64),
            torch.tensor(0.1, device="cuda", dtype=torch.float64) if sym else None,
        ]
        cot = None
        grads = []
        for fn in (lambda a, b, v, d: gram.rbf_gram(a, b, var=v, diag=d), gram.rbf_gram_plain):
            inputs = [None if t is None else t.clone().requires_grad_() for t in leaves]
            out = fn(*inputs)
            if cot is None:
                cot = torch.randn(out.shape, generator=gen, device="cuda", dtype=torch.float64)
            grads.append(torch.autograd.grad(out, [t for t in inputs if t is not None], cot))
        for a, b in zip(*grads):
            worst = max(worst, float((a - b).abs().max() / b.abs().max().clamp_min(1e-300)))
    print(f"# kernel rbf_gram backward f64 (4096, 4096)+diag and (4096, {Q}): max rel "
          f"|kernel-autograd of plain| = {worst:.3e} (tol {F64_REL_TOL})", flush=True)
    check(worst <= F64_REL_TOL, f"rbf_gram backward vs plain autograd {worst} > {F64_REL_TOL}")
    return {"case": "backward", "dtype": "float64", "max_rel_err": worst, "tol": F64_REL_TOL}


def contraction_inputs(torch, n, d, dy, dtype, seed):
    """K⁻¹ (symmetric), A, x̃, log σ² and log α on the card.  Two rows of x̃
    are one point, so matern12's E mask is hit off the diagonal; its
    coordinates are multiples of 1/4, which keeps the plain twin's norm
    identity exact for the pair (r² = ±eps there would make E = G/r huge)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ell = torch.rand(d, generator=gen, device="cuda", dtype=dtype) + 0.5
    xs = torch.randn(n, d, generator=gen, device="cuda", dtype=dtype) / ell
    xs[n // 2] = xs[n // 3] = torch.arange(d, device="cuda", dtype=dtype) % 5 * 0.25 - 0.5
    M = torch.randn(n, n, generator=gen, device="cuda", dtype=dtype)
    Kinv = M + M.mT
    del M
    A = torch.randn(n, dy, generator=gen, device="cuda", dtype=dtype)
    log_var = torch.tensor(0.2, device="cuda", dtype=dtype)
    log_extra = torch.tensor([-0.5], device="cuda", dtype=dtype)
    return Kinv, A, xs.contiguous(), log_var, log_extra


def contraction_error(torch, contract, got, inputs, dy, kind, ref_dtype):
    """Largest |kernel − twin| over the outputs, relative to each output's
    sum of absolute terms, with the twin run in ``ref_dtype``; the largest
    absolute difference; and the relative error of each output (svar,
    rowsum, MX, sextra)."""
    ref = [t.to(ref_dtype) for t in inputs]
    want = contract.radial_contractions_plain(*ref[:4], dy, kind, ref[4])
    scales = contract.contraction_scales(*ref[:4], dy, kind, ref[4])
    rels, absolute = [], 0.0
    for a, b, s in zip(got, want, scales):
        err = (a.to(ref_dtype) - b).abs()
        rels.append(float((err / s.clamp_min(1e-300)).max()))
        absolute = max(absolute, float(err.max()))
    return max(rels), absolute, rels


def contraction_phase(torch, contract):
    rows = []
    n, dy = 4096, 1
    for dtype in (torch.float32, torch.float64):
        name = dtype_name(dtype)
        inputs = contraction_inputs(torch, n, D, dy, dtype, seed=7)
        for kind in KINDS:
            with torch.no_grad():
                got = contract.radial_contractions(*inputs[:4], dy, kind, inputs[4])
                torch.cuda.synchronize()
                rel, absolute, _ = contraction_error(torch, contract, got, inputs, dy, kind, torch.float64)
                ms = time_ms(lambda: contract.radial_contractions(*inputs[:4], dy, kind, inputs[4]), 20)
            tol = CONTRACT_TOL[name]
            print(f"# kernel radial_contractions {kind:8s} {name} n={n} d={D} dy={dy}: "
                  f"max |kernel-plain|/scale = {rel:.3e} (tol {tol:.0e}), max abs {absolute:.3e}, "
                  f"kernel {ms:.4f} ms", flush=True)
            check(rel <= tol, f"radial_contractions {kind} {name} n={n}: {rel} > {tol}")
            rows.append({"case": kind, "dtype": name, "n": n, "max_rel_err": rel,
                         "max_abs_err": absolute, "tol": tol, "ms": ms})
        del inputs
        torch.cuda.empty_cache()

    # The training path's shape: rbf, float32, n = 32768, d = 8, dy = 1.
    # The twin runs in float32 here (in float64 it would not fit beside its
    # n² temporaries); rbf has no 1/r map, so its float32 r² is harmless.
    inputs = contraction_inputs(torch, N, D, dy, torch.float32, seed=8)
    with torch.no_grad():
        got = contract.radial_contractions(*inputs[:4], dy, "rbf")
        torch.cuda.synchronize()
        rel, absolute, rels = contraction_error(torch, contract, got, inputs, dy, "rbf", torch.float32)
        del got
        torch.cuda.empty_cache()
        ms = time_ms(lambda: contract.radial_contractions(*inputs[:4], dy, "rbf"), 50)
        plain_ms = time_ms(lambda: contract.radial_contractions_plain(*inputs[:4], dy, "rbf"), 2)
    bound, bound_by = contract_bound_ms(N, D, dy, "float32", 4)
    tol = CONTRACT_TOL["float32"]
    print(f"# kernel radial_contractions rbf float32 n={N} d={D} dy={dy}: max |kernel-plain|/scale "
          f"= {rel:.3e} (tol {tol:.0e}; svar, rowsum, MX: {rels[0]:.3e}, {rels[1]:.3e}, {rels[2]:.3e}), "
          f"max abs {absolute:.3e}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
          f"({bound_by})", flush=True)
    check(rel <= tol, f"radial_contractions rbf float32 n={N}: {rel} > {tol}")
    rows.insert(0, {"case": "rbf", "dtype": "float32", "n": N, "max_rel_err": rel,
                    "max_abs_err": absolute, "tol": tol, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound, "bound_by": bound_by})

    # All five kinds at the training shape, the kernel alone (windows of
    # 30 launches, ~60 ms: shorter ones after host work read the card's
    # clock still ramping up, up to 25 % slow), against the read bound:
    # at d = 8, dy = 1 every kind's operations take less time than its bytes.
    gbytes = contract_bytes(N, D, dy, 4) / 1e9
    kbound, kby = bound_ms(contract_bytes(N, D, dy, 4), 0, "float32")
    for kind in KINDS:
        with torch.no_grad():
            kms = time_ms(lambda: contract.radial_contractions(*inputs[:4], dy, kind, inputs[4]), 30)
        print(f"# kernel radial_contractions {kind:8s} float32 n={N} d={D} dy={dy}: kernel {kms:.4f} ms, "
              f"{1e3 * gbytes / kms:.1f} GB/s, {100 * kbound / kms:.1f} % of the {kbound:.4f} ms bound ({kby})",
              flush=True)
        rows.append({"case": kind, "dtype": "float32", "n": N, "ms": kms, "gb_per_s": 1e3 * gbytes / kms,
                     "bound_ms": kbound, "bound_by": kby})
    del inputs
    torch.cuda.empty_cache()
    return rows


def make_data(n, d, dtype, seed=0):
    """bench.py's and bench_serving.py's data: x ~ N(0, I), y = sin(x_0) +
    0.1·noise, and BATCHES query batches of Q points."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(dtype)
    y = (np.sin(x[:, :1]) + 0.1 * rng.randn(n, 1)).astype(dtype)
    xq = [rng.randn(Q, d).astype(dtype) for _ in range(BATCHES)]
    return x, y, xq


def zero_counts():
    from gptorch_tpu_torch import ops

    ops.reset_launch_counts()


def read_counts():
    """Every kernel's launches since the last :func:`zero_counts`, by name."""
    from gptorch_tpu_torch import ops

    return ops.launch_counts()


def replayed_launches():
    """The kernel launches of the last ``fit_scan`` call's graph replays:
    the launches its captured step recorded times the replays ({} for an
    eager call).  A wrapper's counter counts launches from the host, and a
    replay launches the recorded kernels from the graph, so a path's
    launches are its counter plus these."""
    from gptorch_tpu_torch.training import fit

    run = fit.fit_scan.last_run
    if not run["captured"]:
        return {}
    return {k: v * run["steps"] for k, v in run["launches_per_step"].items()}


def add_counts(*counts):
    from gptorch_tpu_torch import ops

    out = dict.fromkeys(ops.launch_counts(), 0)
    for c in counts:
        for k, v in c.items():
            out[k] += v
    return out


@contextlib.contextmanager
def counted(total):
    """Adds to ``total`` (launches by kernel name) the launches made inside
    the block: the counts are set to 0 just before it and read just after,
    so a path's launches can be summed over the blocks of its own run and
    leave out the checks run between them."""
    zero_counts()
    yield
    total.update(add_counts(total, read_counts()))


def check_captured(what):
    from gptorch_tpu_torch.training import fit

    run = fit.fit_scan.last_run
    check(run["captured"], f"{what}: fit_scan ran eagerly on the card")
    return dict(run["launches_per_step"])


def serving_phase(torch, gram, contract):
    from gptorch_tpu_torch import kernels, likelihoods, settings
    from gptorch_tpu_torch.models import GPR

    x, y, xq = make_data(N, D, np.float32)
    out = {"n": N, "d": D, "q": Q, "batches": BATCHES, "dtype": "float32"}
    with settings.override(jitter_policy="fixed"):
        model = GPR(x, y, kernels.Rbf(D, ARD=True), likelihood=likelihoods.Gaussian(0.1))
        check(model.device.type == "cuda", "GPR did not land on the card")
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        post = model.posterior()
        torch.cuda.synchronize()
        out["factorize_ms"] = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        serving = post.for_serving()
        torch.cuda.synchronize()
        out["convert_ms"] = 1e3 * (time.perf_counter() - t0)
        predict_ms, mean_ms = [], []
        means, variances, mean_only = [], [], []
        for xb in xq:
            t0 = time.perf_counter()
            mu, var = serving.predict_f(xb)
            predict_ms.append(1e3 * (time.perf_counter() - t0))
            t0 = time.perf_counter()
            m = serving.mean_only(xb)
            mean_ms.append(1e3 * (time.perf_counter() - t0))
            means.append(mu), variances.append(var), mean_only.append(m)
        out["launches"] = read_counts()
        out["predict_f_ms"] = predict_ms
        out["mean_only_ms"] = mean_ms
        check(out["launches"]["rbf_gram"] > 0, "the serving path never launched rbf_gram")
        mu, var, m = np.concatenate(means), np.concatenate(variances), np.concatenate(mean_only)
        out["finite"] = bool(np.isfinite(mu).all() and np.isfinite(var).all() and np.isfinite(m).all())
        check(out["finite"], "non-finite serving output")
        check(mu.shape == (Q * BATCHES, 1) and var.shape == mu.shape, "wrong output shape")

        trtrs_ms, ref_mu, ref_var = [], [], []
        for xb in xq:
            t0 = time.perf_counter()
            a, b = post.predict_f(xb)
            trtrs_ms.append(1e3 * (time.perf_counter() - t0))
            ref_mu.append(a), ref_var.append(b)
        ref_mu, ref_var = np.concatenate(ref_mu), np.concatenate(ref_var)
        out["trtrs_predict_f_ms"] = trtrs_ms
        out["serving_vs_trtrs"] = {
            "mean_max_abs": float(np.abs(mu - ref_mu).max()),
            "var_max_abs": float(np.abs(var - ref_var).max()),
            "mean_only_max_abs": float(np.abs(m - mu).max()),
            "tol": SERVING_TOL,
        }
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["stages_ms"] = serving_stages(torch, model, post, serving, xq[0])
        del model, post, serving
        torch.cuda.empty_cache()
    agree = out["serving_vs_trtrs"]
    print(f"# serving n={N} d={D} f32: factorize {out['factorize_ms']:.1f} ms, "
          f"convert {out['convert_ms']:.1f} ms, predict_f per batch of {Q} "
          f"median {np.median(predict_ms):.3f} ms, mean_only median {np.median(mean_ms):.3f} ms, "
          f"trtrs predict_f median {np.median(trtrs_ms):.3f} ms, launches "
          f"{out['launches']}, outputs finite {out['finite']}; serving vs trtrs max abs: mean "
          f"{agree['mean_max_abs']:.3e}, var {agree['var_max_abs']:.3e}, mean_only "
          f"{agree['mean_only_max_abs']:.3e} (tol {SERVING_TOL})", flush=True)
    for key in ("mean_max_abs", "var_max_abs", "mean_only_max_abs"):
        check(agree[key] <= SERVING_TOL, f"serving vs trtrs {key} {agree[key]} > {SERVING_TOL}")
    out["f64_rerun"] = f64_rerun(torch, kernels, likelihoods, settings, GPR, gram)
    return out


def serving_stages(torch, model, post, serving, xb):
    """Warm CUDA-event times of the serving path's stages, one by one, on
    the objects the main run built (after its launch counts were read)."""
    from gptorch_tpu_torch.functions import cholesky, trtrs
    from gptorch_tpu_torch.ops.blocked import blocked_trtri

    with torch.no_grad():
        xq = torch.as_tensor(xb, device=model.device)
        K = model._compute_kyy()
        k_xs = model.kernel.K(model.X, xq)
        stages = {
            "posterior: Gram K(X,X)+noise (rbf_gram)": (model._compute_kyy, 5),
            "posterior: cholesky": (lambda: cholesky(K), 2),
            "posterior: trtrs V": (lambda: trtrs(model.Y, post.L), 5),
            "for_serving: blocked_trtri": (lambda: blocked_trtri(post.L), 2),
            "predict: cross Gram K(X,x*) (rbf_gram)": (lambda: model.kernel.K(model.X, xq), 20),
            "predict: Linv @ k": (lambda: serving.Linv @ k_xs, 20),
            "predict: k.T @ alpha": (lambda: k_xs.T @ serving.alpha, 20),
            "trtrs posterior predict: L^-1 k": (lambda: trtrs(k_xs, post.L), 20),
        }
        times = {name: time_ms(fn, reps) for name, (fn, reps) in stages.items()}
        del K, k_xs
    for name, ms in times.items():
        print(f"# stage {name}: {ms:.3f} ms", flush=True)
    return times


def f64_rerun(torch, kernels, likelihoods, settings, GPR, gram):
    """n = 4096 in float64: the card's route (kernel + cuSOLVER/cuBLAS) and
    the CPU's plain route on the same data must agree to 1e-8."""
    n = 4096
    x, y, xq = make_data(n, D, np.float64, seed=1)
    results = {}
    with default_dtype(torch, torch.float64), settings.override(jitter_policy="fixed"):
        before = gram.rbf_gram.launches
        for device in ("cuda", "cpu"):
            model = GPR(x, y, kernels.Rbf(D, ARD=True), likelihood=likelihoods.Gaussian(0.1), device=device)
            serving = model.posterior().for_serving()
            mu, var = serving.predict_f(xq[0])
            results[device] = (mu, var, serving.mean_only(xq[0]))
        launched = gram.rbf_gram.launches - before
    rel = max(
        float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))
        for a, b in zip(results["cuda"], results["cpu"])
    )
    print(f"# f64 rerun n={n}: card vs CPU plain route max rel diff {rel:.3e} "
          f"(tol {F64_REL_TOL}), rbf_gram launches {launched}", flush=True)
    check(launched > 0, "the f64 card route never launched rbf_gram")
    check(rel <= F64_REL_TOL, f"f64 card vs CPU route {rel} > {F64_REL_TOL}")
    return {"n": n, "max_rel_diff": rel, "tol": F64_REL_TOL, "launches": launched}


def training_phase(torch, gram, contract):
    from gptorch_tpu_torch import kernels, likelihoods
    from gptorch_tpu_torch.models import GPR

    x, y, _ = make_data(N, D, np.float32)
    model = GPR(x, y, kernels.Rbf(D, ARD=True), likelihood=likelihoods.Gaussian(0.1),
                fast=True, fast_block=TRAIN_NB, fast_jitter=TRAIN_JITTER)
    check(model.device.type == "cuda", "GPR did not land on the card")
    check(model._fast_eligible(model.X), "the flagship model is not on the fused radial path")
    from gptorch_tpu_torch.module import get_trainable
    from gptorch_tpu_torch.training import fit

    out = {"n": N, "d": D, "dtype": "float32", "method": "Adam", "steps": TRAIN_STEPS, "lr": TRAIN_LR}
    start = {k: v.detach().clone() for k, v in get_trainable(model).items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    warm = model.fit_scan("Adam", max_iter=TRAIN_STEPS, learning_rate=TRAIN_LR)  # warm-up step, capture, replays
    torch.cuda.synchronize()
    out["warm_call_s"] = time.perf_counter() - t0
    out["launches_per_captured_step"] = check_captured("training")
    # the eager warm-up step and the capture allocate what a step holds;
    # replays reuse the graph's pool, which the allocator's peak does not see
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9

    zero_counts()
    t0 = time.perf_counter()
    losses = model.fit_scan("Adam", max_iter=TRAIN_STEPS, learning_rate=TRAIN_LR)  # replays of the cached graph
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out["launches"] = add_counts(read_counts(), replayed_launches())
    out["step_ms"] = 1e3 * wall / TRAIN_STEPS
    out["steps_per_s"] = TRAIN_STEPS / wall
    out["losses"] = [float(v) for v in torch.cat([warm, losses]).cpu()]
    print(f"# training n={N} d={D} f32 fit_scan Adam lr={TRAIN_LR} (captured CUDA graph): warm call of "
          f"{TRAIN_STEPS} steps {out['warm_call_s']:.3f} s; timed call {out['step_ms']:.2f} ms/step, "
          f"{out['steps_per_s']:.4f} steps/s, launches {out['launches']} (recorded per captured step "
          f"{out['launches_per_captured_step']} x {TRAIN_STEPS} replays), peak device memory "
          f"{out['peak_mem_gb']:.2f} GB, losses {out['losses']}", flush=True)
    for name in ("rbf_gram", "radial_contractions"):
        check(out["launches"][name] > 0, f"the training path never launched {name}")
    check(all(math.isfinite(v) for v in out["losses"]), "non-finite training loss")
    check(out["losses"][-1] < out["losses"][0], "training did not lower the loss")

    # the same first call run eagerly from the same values
    fit.release_graphs(model)
    torch.cuda.empty_cache()
    with torch.no_grad():
        for k, v in get_trainable(model).items():
            v.copy_(start[k])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, eager = fit._fit_scan(model, "Adam", TRAIN_STEPS, TRAIN_LR, None, capture=False)
    torch.cuda.synchronize()
    out["eager_step_ms"] = 1e3 * (time.perf_counter() - t0) / TRAIN_STEPS
    eager = [float(v) for v in eager.cpu()]
    out["captured_vs_eager_rel"] = max(abs(a - b) / abs(b) for a, b in zip(out["losses"][:TRAIN_STEPS], eager))
    print(f"# training captured vs eager (the first call's {TRAIN_STEPS} steps from the same values): losses "
          f"max rel {out['captured_vs_eager_rel']:.3e} (tol {EXACT_CAPTURE_RTOL}); eager step "
          f"{out['eager_step_ms']:.2f} ms (first eager call), eager losses {eager}", flush=True)
    check(out["captured_vs_eager_rel"] <= EXACT_CAPTURE_RTOL,
          f"training captured vs eager losses {out['captured_vs_eager_rel']} > {EXACT_CAPTURE_RTOL}")

    out["stages_ms"] = training_stages(torch, model)
    vg = out["stages_ms"]["value_and_grad (loss + backward)"][0]
    print(f"# training step: captured {out['step_ms']:.2f} ms vs eager value-and-grad {vg:.2f} ms (CUDA events) "
          f"and eager step {out['eager_step_ms']:.2f} ms", flush=True)
    out["f32_vs_f64"] = full_width_agreement(torch, model)
    del model
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = card_vs_cpu(torch, gram, contract)
    return out


def training_stages(torch, model):
    """Warm CUDA-event times of one value-and-grad of the fused radial NLML
    and of its stages, one by one, at the trained values (after the main
    run's launch counts were read), each beside its bound.  Bounds count
    float32 elements moved (the triangle a triangular operand needs) and
    operations: n³/3 for the Cholesky, the triangular inverse and LᵀL, n²
    for a triangular solve with one right-hand side; the whole
    value-and-grad is bounded by the sum of its stages' bounds."""
    from gptorch_tpu_torch.ops import blocked, contract, gpr_fast

    def value_and_grad():
        model.zero_grad(set_to_none=True)
        model._loss().backward()

    vg_ms = time_ms(value_and_grad, 2)
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    n3, tri = N ** 3 / 3, N * N / 2
    with torch.no_grad():
        log_ell = model.kernel.length_scales.raw
        log_var = model.kernel.variance.raw.reshape(())
        log_noise = model.likelihood.variance.raw.reshape(())
        xs = gpr_fast._scaled(model.X, log_ell).contiguous()
        diag = torch.exp(log_noise) + model.fast_jitter + model.fast_rel_jitter * torch.exp(log_var)
        K = gpr_fast._gram(xs, log_var, "rbf", diag)
        L = blocked.blocked_cholesky(K, TRAIN_NB, lower_only=True)
        alpha = blocked.blocked_ltrsm(L, model.Y, leaf=4096)
        A = blocked._solve_lower_t(L, alpha)
        Linv = blocked.blocked_trtri(L, 1024)
        Kinv = blocked.tril_square_rec(Linv, 512, 4096)
        # name: (fn, reps, bound (ms, by), part of the value-and-grad)
        stages = {
            "forward: Gram K + noise (rbf_gram, K1)": (
                lambda: gpr_fast._gram(xs, log_var, "rbf", diag), 5, gram_bound_ms(N, N, D, True, "float32", 4),
                True),
            "forward: copy of K (blocked_cholesky copies its input)": (
                K.clone, 5, bound_ms(2 * N * N * 4, 0, "float32"), False),
            "forward: blocked_cholesky (nb 1024, right-looking; incl. the copy)": (
                lambda: blocked.blocked_cholesky(K, TRAIN_NB, lower_only=True), 2,
                bound_ms(2 * tri * 4, n3, "float32"), True),
            "yardstick: torch.linalg.cholesky_ex on the same K": (
                lambda: torch.linalg.cholesky_ex(K), 2, bound_ms(2 * tri * 4, n3, "float32"), False),
            "forward: blocked_ltrsm alpha = L^-1 y (leaf 4096)": (
                lambda: blocked.blocked_ltrsm(L, model.Y, leaf=4096), 5,
                bound_ms((tri + 2 * N) * 4, N * N, "float32"), True),
            "backward: A = L^-T alpha (solve_triangular)": (
                lambda: blocked._solve_lower_t(L, alpha), 5, bound_ms((tri + 2 * N) * 4, N * N, "float32"), True),
            "backward: blocked_trtri (nb 1024)": (
                lambda: blocked.blocked_trtri(L, 1024), 2, bound_ms(2 * tri * 4, n3, "float32"), True),
            "backward: tril_square_rec (nb 512, leaf 4096)": (
                lambda: blocked.tril_square_rec(Linv, 512, 4096), 2, bound_ms((tri + N * N) * 4, n3, "float32"),
                True),
            "backward: radial_contractions (K2)": (
                lambda: contract.radial_contractions(Kinv, A, xs, log_var, 1, "rbf"), 5,
                contract_bound_ms(N, D, 1, "float32", 4), True),
        }
        times = {name: (time_ms(fn, reps), *bound) for name, (fn, reps, bound, _) in stages.items()}
        del K, L, alpha, A, Linv, Kinv
    torch.cuda.empty_cache()
    vg_bound = sum(bound[0] for _, _, bound, part in stages.values() if part)
    times = {"value_and_grad (loss + backward)": (vg_ms, vg_bound, "sum of its stages"), **times}
    for name, (ms, bound, by) in times.items():
        print(f"# stage {name}: {ms:.3f} ms (bound {bound:.3f} ms, {by})", flush=True)
    return times


def full_width_agreement(torch, model):
    """NLML and gradient of the fused radial path at n = 32768 in float32
    against the same computation in float64 on the card, at the trained
    values.  Tolerance 4·u·κ (u the float32 unit roundoff, κ a bound on the
    condition number of K from this run's data): the Gram, the Cholesky
    factor and the solves carry relative errors of a few u, which K⁻¹
    amplifies by at most κ in the solution, the log-determinant and the
    gradient's K⁻¹ terms.  κ ≤ λ_max / (σ_n² + jitter + rel·σ²): the noise
    floor bounds λ_min from below, and λ_max comes from 30 power
    iterations in float64."""
    from gptorch_tpu_torch.ops import gpr_fast

    raws = [model.kernel.length_scales.raw, model.kernel.variance.raw.reshape(()),
            model.likelihood.variance.raw.reshape(())]
    results = {}
    for dtype in (torch.float32, torch.float64):
        params = [r.detach().to(dtype).clone().requires_grad_() for r in raws]
        value = gpr_fast.radial_nlml("rbf", *params, model.X.to(dtype), model.Y.to(dtype),
                                     model.fast_jitter, model.fast_block, model.fast_rel_jitter)
        grads = torch.autograd.grad(value, params)
        results[dtype] = (float(value.detach()), np.concatenate([g.double().cpu().numpy().ravel() for g in grads]))
        del value, grads
        torch.cuda.empty_cache()
    kappa = rbf_kappa(torch, model, *raws)
    tol = 4 * F32_UNIT_ROUNDOFF * kappa
    (v32, g32), (v64, g64) = results[torch.float32], results[torch.float64]
    value_rel = abs(v32 - v64) / abs(v64)
    grad_rel = float(np.abs(g32 - g64).max() / np.abs(g64).max())
    print(f"# training f32 vs f64 at n={N}: NLML {v32!r} vs {v64!r} (rel {value_rel:.3e}); gradient "
          f"max|g32-g64|/max|g64| = {grad_rel:.3e}; kappa <= {kappa:.1f}, tol 4*u*kappa = {tol:.3e}; "
          f"g64 = {g64.tolist()}", flush=True)
    check(value_rel <= tol, f"f32 vs f64 NLML at n={N}: {value_rel} > {tol}")
    check(grad_rel <= tol, f"f32 vs f64 gradient at n={N}: {grad_rel} > {tol}")
    return {"nlml_f32": v32, "nlml_f64": v64, "value_rel": value_rel, "grad_rel": grad_rel,
            "kappa_bound": kappa, "tol": tol}


def rbf_kappa(torch, model, log_ell, log_var, log_noise):
    """A bound on the condition number of the fused path's noisy Rbf Gram
    of ``model`` at the given raw values, in float64: λ_max by 30 power
    iterations over the noise floor (σ_n² + jitter + rel·σ²), which bounds
    λ_min from below."""
    from gptorch_tpu_torch.ops import gpr_fast

    with torch.no_grad():
        p = [r.detach().double() for r in (log_ell, log_var, log_noise)]
        xs = gpr_fast._scaled(model.X.double(), p[0]).contiguous()
        floor = torch.exp(p[2]) + model.fast_jitter + model.fast_rel_jitter * torch.exp(p[1])
        K = gpr_fast._gram(xs, p[1], "rbf", floor)
        v = torch.ones(K.shape[0], 1, dtype=torch.float64, device=K.device)
        for _ in range(30):
            v = K @ v
            lam_max = float(v.norm())
            v /= lam_max
        del K
    torch.cuda.empty_cache()
    return lam_max / float(floor)


def card_vs_cpu(torch, gram, contract):
    """n = 4096 in float64: loss and gradient of GPR on the card against the
    CPU's plain route, to 1e-8 relative (the gradient relative to its
    largest entry): the fused radial, generic and kernel-general paths, the
    reference example's composite, the leave-one-out objective (blocked
    factor), and inputs too wide for the contraction kernel (d = 33 or
    dy = 33), which the card routes to the kernel-general path while the
    CPU keeps the fused one."""
    from gptorch_tpu_torch import kernels, likelihoods, mean_functions, settings
    from gptorch_tpu_torch.models import GPR
    from gptorch_tpu_torch.module import get_trainable

    n = 4096
    x, y, _ = make_data(n, D, np.float64, seed=2)
    wide_x = np.random.RandomState(3).randn(n, 33)
    wide_y = np.sin(x[:, :1] * np.arange(1, 34)) + 0.1 * np.random.RandomState(4).randn(n, 33)
    ell = np.linspace(0.8, 1.6, D)

    def rbf(d=D):
        return kernels.Rbf(d, ARD=True, length_scales=np.linspace(0.8, 1.6, d) * math.sqrt(d / D), variance=1.3)

    # route: (kernel, mean, fast, objective, x, y)
    routes = {
        "fused radial (Rbf, fast=True)": lambda: (rbf(), None, True, "nlml", x, y),
        "generic (Rbf, fast=False)": lambda: (rbf(), None, False, "nlml", x, y),
        "general (Rbf + Matern32, LinearMean)": lambda: (
            kernels.Rbf(D, ARD=True, length_scales=ell, variance=1.3) + kernels.Matern32(D, variance=0.4),
            mean_functions.LinearMean(D, 1, W=0.1 * np.ones((1, D)), b=np.array([0.2])), True, "nlml", x, y),
        "general (Linear + Rbf + Constant)": lambda: (composite_kernel(kernels, D), None, None, "nlml", x, y),
        "loo (Rbf, blocked factor)": lambda: (rbf(), None, None, "loo", x, y),
        "wide d=33 (Rbf)": lambda: (rbf(33), None, None, "nlml", wide_x, y),
        "wide dy=33 (Rbf)": lambda: (rbf(), None, None, "nlml", x, wide_y),
    }
    general = lambda c: c["rbf_gram"] >= 2 and c["radial_contractions"] == 0  # noqa: E731
    expect = {  # (rbf_gram, radial_contractions) launches on the card
        "fused radial (Rbf, fast=True)": lambda c: c["rbf_gram"] == 1 and c["radial_contractions"] == 1,
        "generic (Rbf, fast=False)": lambda c: c["rbf_gram"] >= 1,
        "general (Rbf + Matern32, LinearMean)": general,
        "general (Linear + Rbf + Constant)": general,
        "loo (Rbf, blocked factor)": lambda c: c["rbf_gram"] >= 1 and c["radial_contractions"] == 0,
        "wide d=33 (Rbf)": general,
        "wide dy=33 (Rbf)": general,
    }
    out = {}
    with default_dtype(torch, torch.float64), settings.override(jitter_policy="fixed"):
        for route, make in routes.items():
            res = {}
            for device in ("cuda", "cpu"):
                kern, mean, fast, objective, xr, yr = make()
                model = GPR(xr, yr, kern, mean_function=mean, likelihood=likelihoods.Gaussian(0.1), fast=fast,
                            fast_block=TRAIN_NB, objective=objective, device=device)
                fused = model._fast_eligible(model.X)
                zero_counts()
                loss = model.loss()
                loss.backward()
                raws = get_trainable(model)
                res[device] = (float(loss.detach()), np.concatenate([raws[k].grad.cpu().numpy().ravel()
                                                            for k in sorted(raws)]), read_counts(),
                               fused)
                del model, loss, raws
            value_rel = abs(res["cuda"][0] - res["cpu"][0]) / abs(res["cpu"][0])
            grad_rel = float(np.abs(res["cuda"][1] - res["cpu"][1]).max() / np.abs(res["cpu"][1]).max())
            print(f"# training f64 card vs CPU n={n} {route}: loss rel {value_rel:.3e}, gradient rel "
                  f"{grad_rel:.3e} (tol {F64_REL_TOL}), card launches {res['cuda'][2]}, fused route on the card "
                  f"{res['cuda'][3]}, on the CPU {res['cpu'][3]}", flush=True)
            check(expect[route](res["cuda"][2]), f"{route}: unexpected launches {res['cuda'][2]}")
            check(not any(res["cpu"][2].values()), f"{route}: the CPU launched")
            if route.startswith("wide"):
                check(res["cpu"][3] and not res["cuda"][3], f"{route}: the routes are not CPU fused, card general")
            check(value_rel <= F64_REL_TOL, f"{route}: loss card vs CPU {value_rel} > {F64_REL_TOL}")
            check(grad_rel <= F64_REL_TOL, f"{route}: gradient card vs CPU {grad_rel} > {F64_REL_TOL}")
            out[route] = {"value_rel": value_rel, "grad_rel": grad_rel, "launches": res["cuda"][2]}
    torch.cuda.empty_cache()
    return out


def composite_kernel(kernels, d):
    """The reference example's composite: Linear-ARD + Rbf-ARD + Constant."""
    return kernels.Linear(d, ARD=True) + kernels.Rbf(d, ARD=True) + kernels.Constant(d)


def general_training_phase(torch, gram, contract):
    """The kernel-general exact path at bench.py's scale: GPR(n = 32768,
    d = 8, Linear + Rbf + Constant, Gaussian(0.1), fast_jitter=1e-3,
    float32), ``fit_scan`` Adam lr 1e-4 (a warm call and a timed call of
    GEN_STEPS steps), ``predict_f_samples`` of Q queries x GEN_SAMPLES
    draws from a generator on the card and ``predict_f`` there, then
    ``optimize("L-BFGS-B", max_iter=GEN_LBFGS_ITERS)``; then the samples'
    moments against ``predict_f``, the stages of one value-and-grad, and
    float32 against float64 at full n."""
    from gptorch_tpu_torch import kernels, likelihoods
    from gptorch_tpu_torch.models import GPR

    x, y, xq = make_data(N, D, np.float32)
    model = GPR(x, y, composite_kernel(kernels, D), likelihood=likelihoods.Gaussian(0.1), fast_jitter=TRAIN_JITTER)
    check(model.device.type == "cuda", "GPR did not land on the card")
    check(model._general_eligible(model.X) and not model._fast_eligible(model.X),
          "the composite model is not on the kernel-general path")
    out = {"n": N, "d": D, "dtype": "float32", "kernel": "Linear(ARD) + Rbf(ARD) + Constant", "steps": GEN_STEPS,
           "lr": TRAIN_LR}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    warm = model.fit_scan("Adam", max_iter=GEN_STEPS, learning_rate=TRAIN_LR)  # warm-up step, capture, replays
    torch.cuda.synchronize()
    out["warm_call_s"] = time.perf_counter() - t0
    out["launches_per_captured_step"] = check_captured("general training")
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9  # the warm-up step's and the capture's

    zero_counts()
    t0 = time.perf_counter()
    losses = model.fit_scan("Adam", max_iter=GEN_STEPS, learning_rate=TRAIN_LR)  # replays
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    replayed = replayed_launches()
    out["step_ms"] = 1e3 * wall / GEN_STEPS
    # joint samples and the moments they are held against, at the state
    # Adam left (noise 0.1); L-BFGS-B then moves the noise towards the
    # data's 0.01, where float32 no longer resolves the posterior variance
    # at these queries (PERF.md §7)
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    samples = model.predict_f_samples(xq[0], n_samples=GEN_SAMPLES, generator=gen)
    torch.cuda.synchronize()
    out["samples_ms"] = 1e3 * (time.perf_counter() - t0)
    moments = model.predict_f(xq[0])
    t0 = time.perf_counter()
    result = model.optimize("L-BFGS-B", max_iter=GEN_LBFGS_ITERS, verbose=False)
    torch.cuda.synchronize()
    out["lbfgs_s"] = time.perf_counter() - t0
    out["lbfgs_evaluations"] = int(result.nfev)
    out["lbfgs_loss"] = float(result.fun)
    out["launches"] = add_counts(read_counts(), replayed)
    out["losses"] = [float(v) for v in torch.cat([warm, losses]).cpu()]
    print(f"# general training n={N} d={D} f32 {out['kernel']} fit_scan Adam lr={TRAIN_LR} (captured CUDA graph, "
          f"launches recorded per captured step {out['launches_per_captured_step']}): warm call of "
          f"{GEN_STEPS} steps {out['warm_call_s']:.3f} s; timed call {out['step_ms']:.2f} ms/step, peak device "
          f"memory {out['peak_mem_gb']:.2f} GB, losses {out['losses']}; L-BFGS-B max_iter={GEN_LBFGS_ITERS}: "
          f"{out['lbfgs_s']:.3f} s, {out['lbfgs_evaluations']} evaluations, loss {out['lbfgs_loss']!r}; "
          f"predict_f_samples {Q} x {GEN_SAMPLES}: {out['samples_ms']:.1f} ms; launches {out['launches']}",
          flush=True)
    check(out["launches"]["rbf_gram"] > 0, "the general training path never launched rbf_gram")
    check(out["launches"]["radial_contractions"] == 0, "the general training path launched the radial contraction")
    check(all(math.isfinite(v) for v in out["losses"]) and math.isfinite(out["lbfgs_loss"]),
          "non-finite general training loss")
    check(out["losses"][-1] < out["losses"][0], "general training did not lower the loss")

    out["samples"] = sample_moments(samples, *moments)
    out["stages_ms"] = general_stages(torch, model)
    out["f32_vs_f64"] = general_full_width_agreement(torch, model)
    del model
    torch.cuda.empty_cache()
    return out


def general_stages(torch, model):
    """Warm CUDA-event times of one value-and-grad of the kernel-general
    NLML and of its stages, one by one, each beside its bound (float32
    elements moved, a triangular operand's triangle, or operations: n³/3
    for the Cholesky, the triangular inverse and LᵀL; per Gram entry 2d for
    Linear, 3d + 3 for Rbf and 2 for the sums; per entry of the chunked
    VJP, 9d + 9: W, the two Grams again and their cotangent products)."""
    from gptorch_tpu_torch.module import trainable_parameters
    from gptorch_tpu_torch.ops import blocked, gpr_general

    def value_and_grad():
        model.zero_grad(set_to_none=True)
        model._loss().backward()

    vg_ms = time_ms(value_and_grad, 1)
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    n3, tri = N ** 3 / 3, N * N / 2
    kernel, X, Y = model.kernel, model.X, model.Y
    params = trainable_parameters(kernel)
    with torch.no_grad():
        noise = model.likelihood.variance.value.reshape(())
        floor = noise + model.fast_jitter + model.fast_rel_jitter * torch.mean(kernel.Kdiag(X))
        K = kernel.K(X)
        K.diagonal().add_(floor)
        L = blocked.blocked_cholesky(K, model.fast_block, lower_only=True)
        alpha = blocked._solve_lower(L, Y)
        A = blocked._solve_lower_t(L, alpha)
        Linv = blocked.blocked_trtri(L, 1024)
        Kinv = blocked.tril_square_rec(Linv, 512, 4096)

    def chunked_vjp():
        for lo, hi in gpr_general._chunk_bounds(N):
            W_c = Kinv[lo:hi] - A[lo:hi] @ A.mT
            with torch.enable_grad():
                torch.autograd.grad(kernel.K(X[lo:hi], X), params, grad_outputs=0.5 * W_c)

    gram_bound = bound_ms((N * D + N * N) * 4, N * N * (2 * D + 3 * D + 3 + 2), "float32")
    stages = {
        "forward: Gram K (Linear + Rbf (rbf_gram, K1) + Constant)": (lambda: kernel.K(X), 3, gram_bound),
        "forward: blocked_cholesky (nb 1024; incl. the copy)": (
            lambda: blocked.blocked_cholesky(K, model.fast_block, lower_only=True), 1,
            bound_ms(2 * tri * 4, n3, "float32")),
        "backward: blocked_trtri (nb 1024)": (lambda: blocked.blocked_trtri(L, 1024), 1,
                                              bound_ms(2 * tri * 4, n3, "float32")),
        "backward: tril_square_rec (nb 512, leaf 4096)": (lambda: blocked.tril_square_rec(Linv, 512, 4096), 1,
                                                          bound_ms((tri + N * N) * 4, n3, "float32")),
        "backward: chunked kernel VJP (4096-row chunks, K1 forward + torch backward)": (
            chunked_vjp, 1, bound_ms((N * N + N * D) * 4, N * N * (9 * D + 9), "float32")),
    }
    times = {name: (time_ms(fn, reps), *bound) for name, (fn, reps, bound) in stages.items()}
    del K, L, alpha, A, Linv, Kinv
    torch.cuda.empty_cache()
    vg_bound = sum(t[1] for t in times.values())
    times = {"value_and_grad (loss + backward)": (vg_ms, vg_bound, "sum of its stages"), **times}
    for name, (ms, bound, by) in times.items():
        print(f"# general stage {name}: {ms:.3f} ms (bound {bound:.3f} ms, {by})", flush=True)
    return times


def sample_moments(samples, mean, var, what="general"):
    """The draws' mean and variance at each query against ``predict_f``'s
    (``mean``, ``var``), in standard errors: sd/√S for the mean,
    σ²·√(2/(S − 1)) for the variance; each must stay within 5."""
    S = samples.shape[0]
    check(samples.shape == (S, Q, 1) and np.isfinite(samples).all(), "bad predict_f_samples output")
    m_se = np.abs(samples.mean(0) - mean) / np.sqrt(var / S)
    v_se = np.abs(samples.var(0, ddof=1) - var) / (var * math.sqrt(2.0 / (S - 1)))
    out = {"mean_max_se": float(m_se.max()), "var_max_se": float(v_se.max()), "var_range": [float(var.min()),
                                                                                         float(var.max())]}
    print(f"# {what} predict_f_samples {S} x {Q}: sample mean within {out['mean_max_se']:.2f} standard errors "
          f"of predict_f, sample variance within {out['var_max_se']:.2f} (limit 5); predict_f variance "
          f"{out['var_range'][0]:.3e} .. {out['var_range'][1]:.3e}", flush=True)
    check(out["mean_max_se"] <= 5 and out["var_max_se"] <= 5, "predict_f_samples moments disagree with predict_f")
    return out


def general_full_width_agreement(torch, model):
    """NLML and gradient of the kernel-general path at n = 32768 in float32
    against a float64 copy of the model on the card.  Tolerance 4·u·κ, as
    for the fused path (:func:`full_width_agreement`), with κ ≤ λ_max /
    floor, floor = σ_n² + jitter + rel·mean(Kdiag) and λ_max from 30 power
    iterations on the float64 K."""
    import copy

    from gptorch_tpu_torch.module import get_trainable

    results = {}
    for dtype in (torch.float32, torch.float64):
        m = model if dtype == torch.float32 else copy.deepcopy(model).to(dtype)
        m.zero_grad(set_to_none=True)
        value = m.loss()
        value.backward()
        raws = get_trainable(m)
        results[dtype] = (float(value.detach()), np.concatenate([raws[k].grad.double().cpu().numpy().ravel()
                                                                 for k in sorted(raws)]))
        m.zero_grad(set_to_none=True)
        del value, raws
        torch.cuda.empty_cache()
    with torch.no_grad():
        kern = m.kernel
        floor = (m.likelihood.variance.value.reshape(()) + m.fast_jitter
                 + m.fast_rel_jitter * torch.mean(kern.Kdiag(m.X)))
        K = kern.K(m.X)
        K.diagonal().add_(floor)
        v = torch.ones(N, 1, dtype=torch.float64, device=K.device)
        for _ in range(30):
            v = K @ v
            lam_max = float(v.norm())
            v /= lam_max
        del K, m
        kappa = lam_max / float(floor)
    torch.cuda.empty_cache()
    tol = 4 * F32_UNIT_ROUNDOFF * kappa
    (v32, g32), (v64, g64) = results[torch.float32], results[torch.float64]
    value_rel = abs(v32 - v64) / abs(v64)
    grad_rel = float(np.abs(g32 - g64).max() / np.abs(g64).max())
    print(f"# general f32 vs f64 at n={N}: NLML {v32!r} vs {v64!r} (rel {value_rel:.3e}); gradient "
          f"max|g32-g64|/max|g64| = {grad_rel:.3e}; kappa <= {kappa:.1f}, tol 4*u*kappa = {tol:.3e}", flush=True)
    check(value_rel <= tol, f"general f32 vs f64 NLML at n={N}: {value_rel} > {tol}")
    check(grad_rel <= tol, f"general f32 vs f64 gradient at n={N}: {grad_rel} > {tol}")
    return {"nlml_f32": v32, "nlml_f64": v64, "value_rel": value_rel, "grad_rel": grad_rel,
            "kappa_bound": kappa, "tol": tol}


def observe_loop_phase(torch, gram, contract):
    """The observe loop of Bayesian optimisation at the serving cell (n =
    32768, d = 8, Rbf-ARD, Gaussian(0.1), fixed jitter, float32):
    ``posterior()``, ``fantasy_chain(capacity=n + OBS_STEPS·OBS_NB)``,
    OBS_STEPS ``observe`` calls of OBS_NB points, ``for_serving()``, and
    ``sample_paths`` on both posteriors over PATH_CANDIDATES candidates.
    Checks: the chain against a fresh factorization of the augmented data,
    one ``condition_on`` of all the new points on each posterior against
    the chain, and paths finite and the same for the same seed."""
    from gptorch_tpu_torch import kernels, likelihoods, settings
    from gptorch_tpu_torch.models import GPR

    x, y, xq = make_data(N, D, np.float32)
    rng = np.random.RandomState(5)
    nb_total = OBS_STEPS * OBS_NB
    xb = rng.randn(nb_total, D).astype(np.float32)
    yb = (np.sin(xb[:, :1]) + 0.1 * rng.randn(nb_total, 1)).astype(np.float32)
    cand = torch.as_tensor(rng.randn(PATH_CANDIDATES, D).astype(np.float32), device="cuda")
    out = {"n": N, "d": D, "dtype": "float32", "steps": OBS_STEPS, "nb": OBS_NB}
    with settings.override(jitter_policy="fixed"):
        model = GPR(x, y, kernels.Rbf(D, ARD=True), likelihood=likelihoods.Gaussian(0.1))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        post = model.posterior()
        torch.cuda.synchronize()
        out["factorize_ms"] = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        chain = post.fantasy_chain(capacity=N + nb_total)
        torch.cuda.synchronize()
        out["chain_ms"] = 1e3 * (time.perf_counter() - t0)
        observe_ms = []
        for i in range(OBS_STEPS):
            t0 = time.perf_counter()
            chain.observe(xb[i * OBS_NB:(i + 1) * OBS_NB], yb[i * OBS_NB:(i + 1) * OBS_NB])
            torch.cuda.synchronize()
            observe_ms.append(1e3 * (time.perf_counter() - t0))
        out["observe_ms"] = observe_ms
        t0 = time.perf_counter()
        serving = post.for_serving()
        torch.cuda.synchronize()
        out["convert_ms"] = 1e3 * (time.perf_counter() - t0)
        paths_out, out["paths_ms"] = {}, {}
        for name, p in (("posterior", post), ("serving", serving)):
            t0 = time.perf_counter()
            paths = p.sample_paths(PATH_SAMPLES, PATH_FEATURES, generator=torch.Generator(device="cuda").manual_seed(0))
            with torch.no_grad():
                paths_out[name] = paths(cand)
            torch.cuda.synchronize()
            out["paths_ms"][name] = 1e3 * (time.perf_counter() - t0)
        out["launches"] = read_counts()
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        print(f"# observe loop n={N} d={D} f32: factorize {out['factorize_ms']:.1f} ms, chain of capacity "
              f"{N + nb_total} {out['chain_ms']:.1f} ms, {OBS_STEPS} observes of {OBS_NB}: median "
              f"{np.median(observe_ms):.3f} ms (first {observe_ms[0]:.3f}, max {max(observe_ms):.3f}); convert "
              f"{out['convert_ms']:.1f} ms; sample_paths({PATH_SAMPLES}, {PATH_FEATURES}) over {PATH_CANDIDATES} "
              f"candidates: posterior {out['paths_ms']['posterior']:.2f} ms, serving "
              f"{out['paths_ms']['serving']:.2f} ms; launches {out['launches']}, peak device memory "
              f"{out['peak_mem_gb']:.2f} GB", flush=True)
        check(out["launches"]["rbf_gram"] > 0, "the observe loop never launched rbf_gram")
        out["checks"] = observe_checks(torch, model, post, serving, chain, xb, yb, xq[0], cand, paths_out)
        out["stages_ms"] = observe_stages(torch, post, chain, xb[:OBS_NB])
    del model, post, serving, chain
    torch.cuda.empty_cache()
    return out


def observe_stages(torch, post, chain, x_new):
    """Warm CUDA-event times of one observe's parts on the full chain, each
    beside its bound: the (C, OBS_NB) cross Gram, the solve against the
    (C, C) buffer (its triangle read once), and as yardsticks the same
    solve against a column-major copy of the buffer and against the
    posterior's n x n factor from cuSOLVER."""
    from gptorch_tpu_torch.functions import trtrs

    C, n = chain.capacity, post.L.shape[0]
    with torch.no_grad():
        xt = torch.as_tensor(x_new, dtype=chain.Xbuf.dtype, device=chain.Xbuf.device)
        k = chain.kernel.K(chain.Xbuf, xt)
        L_col = chain.Lbuf.mT.contiguous().mT
        stages = {
            f"cross Gram K(Xbuf, x_b) ({C}, {OBS_NB}) (rbf_gram)": (
                lambda: chain.kernel.K(chain.Xbuf, xt), gram_bound_ms(C, OBS_NB, D, False, "float32", 4)),
            "solve against Lbuf (C, C), row-major": (
                lambda: trtrs(k, chain.Lbuf), bound_ms((C * C / 2 + 2 * C * OBS_NB) * 4, C * C * OBS_NB, "float32")),
            "yardstick: the same solve, Lbuf copied column-major": (
                lambda: trtrs(k, L_col), bound_ms((C * C / 2 + 2 * C * OBS_NB) * 4, C * C * OBS_NB, "float32")),
            "yardstick: solve against the posterior's n x n L (cuSOLVER's layout)": (
                lambda: trtrs(k[:n], post.L), bound_ms((n * n / 2 + 2 * n * OBS_NB) * 4, n * n * OBS_NB, "float32")),
        }
        times = {name: (time_ms(fn, 10), *bound) for name, (fn, bound) in stages.items()}
        del L_col
    torch.cuda.empty_cache()
    print(f"# observe strides: Lbuf {tuple(chain.Lbuf.stride())}, posterior L {tuple(post.L.stride())}", flush=True)
    for name, (ms, bound, by) in times.items():
        print(f"# observe stage {name}: {ms:.3f} ms (bound {bound:.3f} ms, {by})", flush=True)
    return times


def observe_checks(torch, model, post, serving, chain, xb, yb, xq, cand, paths_out):
    """The chain against a refit and against condition_on, and the paths'
    determinism; moments and paths within SERVING_TOL (f32 factors of this
    data, as in the serving phase)."""
    from gptorch_tpu_torch.models import GPR

    out = {}
    ref = chain.predict_f(xq)
    refit = GPR(torch.cat([model.X, torch.as_tensor(xb, device="cuda")]),
                torch.cat([model.Y, torch.as_tensor(yb, device="cuda")]), model.kernel,
                likelihood=model.likelihood).posterior()
    candidates = {"refit": refit, "chain.posterior()": chain.posterior()}
    for name, p in candidates.items():
        got = p.predict_f(xq)
        out[name] = max(float(np.abs(a - b).max()) for a, b in zip(got, ref))
    del refit, candidates
    torch.cuda.empty_cache()
    for name, p in (("GPRPosterior.condition_on", post), ("ServingGPRPosterior.condition_on", serving)):
        t0 = time.perf_counter()
        cond = p.condition_on(xb, yb)
        torch.cuda.synchronize()
        out[name + " ms"] = 1e3 * (time.perf_counter() - t0)
        got = cond.predict_f(xq)
        out[name] = max(float(np.abs(a - b).max()) for a, b in zip(got, ref))
        del cond
        torch.cuda.empty_cache()
    with torch.no_grad():
        again = post.sample_paths(PATH_SAMPLES, PATH_FEATURES,
                                  generator=torch.Generator(device="cuda").manual_seed(0))(cand)
        a, s = paths_out["posterior"], paths_out["serving"]
        out["paths finite"] = bool(torch.isfinite(a).all() and torch.isfinite(s).all())
        out["paths same seed max abs"] = float((again - a).abs().max())
        out["paths posterior vs serving"] = float((s - a).abs().max())
        out["paths shape"] = list(a.shape)
    print(f"# observe checks (max abs vs the chain's predict_f; tol {SERVING_TOL}): "
          + ", ".join(f"{k} {v:.2f}" if k.endswith(" ms") else f"{k} {v:.3e}" if isinstance(v, float)
                      else f"{k} {v}" for k, v in out.items()), flush=True)
    for key in ("refit", "chain.posterior()", "GPRPosterior.condition_on", "ServingGPRPosterior.condition_on",
                "paths posterior vs serving"):
        check(out[key] <= SERVING_TOL, f"observe loop: {key} {out[key]} > {SERVING_TOL}")
    check(out["paths finite"] and out["paths shape"] == [PATH_SAMPLES, PATH_CANDIDATES, 1], "bad sample paths")
    check(out["paths same seed max abs"] <= 1e-6, "sample_paths differ for the same generator seed")
    return out


def sparse_data(n, d, m, dtype, seed=0):
    """bench_svgp.py's data: x ~ N(0, I), y = sin(x₀) + 0.1·noise, and the
    inducing inputs x[perm[:m]] from the same RandomState stream."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(dtype)
    y = (np.sin(x[:, :1]) + 0.1 * rng.randn(n, 1)).astype(dtype)
    return x, y, x[rng.permutation(n)[:m]]


def device_busy_ms(torch, fn):
    """(wall ms, device-busy ms, {activity name: ms}, device activities) of
    ``fn()`` under ``torch.profiler``.  Busy time is the union of the
    intervals of every kernel, copy and set the card ran; the profiler's
    device-side ranges of user annotations (``Optimizer.step#Adam.step``,
    which span kernels and the gaps between them) are left out, and each
    other activity counts once.  Raises CheckFailed if the trace holds no
    device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    by_name, spans = {}, []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
            spans.append((e.time_range.start, e.time_range.end))
    busy_us, reach = 0.0, -math.inf
    for start, end in sorted(spans):
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    check(busy_us > 0, "torch.profiler recorded no device activity")
    return wall, busy_us / 1e3, by_name, len(spans)


def svgp_training_phase(torch, gram, contract):
    """bench_svgp.py's leg through the port: SVGP(n = 45730, d = 9,
    m = 1024, batch 4096, Rbf-ARD, Gaussian(), jitter 1e-6, fixed jitter
    policy, float32), ``fit_scan`` Adam lr 1e-2, 50 steps a call, one warm
    call and one timed call, with a generator on the card."""
    from gptorch_tpu_torch import kernels, settings
    from gptorch_tpu_torch.models import SVGP

    x, y, z = sparse_data(SP_N, SP_D, SP_M, np.float32)
    out = {"n": SP_N, "d": SP_D, "m": SP_M, "batch": SP_BATCH, "dtype": "float32", "steps": SP_STEPS,
           "lr": SP_LR}
    with settings.override(jitter_policy="fixed"):
        t0 = time.perf_counter()
        model = SVGP(x, y, kernels.Rbf(SP_D, ARD=True), inducing_points=z, batch_size=SP_BATCH,
                     jitter=SP_JITTER)
        torch.cuda.synchronize()
        out["build_s"] = time.perf_counter() - t0
        check(model.device.type == "cuda", "SVGP did not land on the card")
        gen = torch.Generator(device="cuda").manual_seed(0)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        warm = model.fit_scan("Adam", max_iter=SP_STEPS, learning_rate=SP_LR, generator=gen)
        torch.cuda.synchronize()
        out["warm_call_s"] = time.perf_counter() - t0
        out["launches_per_captured_step"] = check_captured("svgp training")
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9  # the warm-up step's and the capture's

        zero_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        losses = model.fit_scan("Adam", max_iter=SP_STEPS, learning_rate=SP_LR, generator=gen)
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out["launches"] = add_counts(read_counts(), replayed_launches())
        out["step_ms"] = 1e3 * wall / SP_STEPS
        out["steps_per_s"] = SP_STEPS / wall
        out["event_span_ms_per_step"] = start.elapsed_time(end) / SP_STEPS
        out["losses"] = [float(v) for v in torch.cat([warm, losses]).cpu()]

        # device activity of a short window of the same loop
        prof_wall, busy, by_name, _ = device_busy_ms(
            torch, lambda: model.fit_scan("Adam", max_iter=SP_PROFILED_STEPS, learning_rate=SP_LR, generator=gen))
        out["profiled_wall_ms_per_step"] = prof_wall / SP_PROFILED_STEPS
        out["device_ms_per_step"] = busy / SP_PROFILED_STEPS
        out["idle_share"] = 1.0 - out["device_ms_per_step"] / out["step_ms"]
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
        out["device_ms_per_step_by_kernel"] = {k: v / SP_PROFILED_STEPS for k, v in top}
        for k, v in top:
            print(f"# svgp device time per step {v / SP_PROFILED_STEPS:.4f} ms ({100 * v / busy:.1f} % of busy): "
                  f"{k[:110]}", flush=True)
        k1 = sum(v for k, v in by_name.items() if "rbf_gram" in k) / SP_PROFILED_STEPS
        out["rbf_gram_device_ms_per_step"] = k1
        print(f"# svgp device time per step in rbf_gram's kernel (K1): {k1:.4f} ms "
              f"({100 * k1 / out['device_ms_per_step']:.2f} % of busy)", flush=True)
        print(f"# svgp training n={SP_N} d={SP_D} m={SP_M} batch={SP_BATCH} f32 fit_scan Adam lr={SP_LR} "
              f"(captured CUDA graph, launches recorded per captured step {out['launches_per_captured_step']}): "
              f"build {out['build_s']:.3f} s, warm call of {SP_STEPS} steps {out['warm_call_s']:.3f} s; timed "
              f"call {out['step_ms']:.4f} ms/step, {out['steps_per_s']:.2f} steps/s, CUDA-event span "
              f"{out['event_span_ms_per_step']:.4f} ms/step; device busy {out['device_ms_per_step']:.4f} ms/step "
              f"(torch.profiler, {SP_PROFILED_STEPS} steps, {out['profiled_wall_ms_per_step']:.4f} ms/step "
              f"profiled), idle share {out['idle_share']:.3f}; launches {out['launches']}, peak device memory "
              f"{out['peak_mem_gb']:.3f} GB", flush=True)
        check(out["launches"]["rbf_gram"] > 0, "the SVGP training path never launched rbf_gram")
        first, last = out["losses"][:10], out["losses"][-10:]
        print(f"# svgp losses: first 10 mean {np.mean(first):.6f}, last 10 mean {np.mean(last):.6f}; "
              f"{out['losses'][:3]} ... {out['losses'][-3:]}", flush=True)
        check(all(math.isfinite(v) for v in out["losses"]), "non-finite SVGP training loss")
        check(np.mean(last) < np.mean(first), "SVGP training did not lower the loss")
        out["stages_ms"] = svgp_stages(torch, model)
        out["f32_vs_f64"] = svgp_full_batch_agreement(torch, model)
    return model, out


def svgp_stages(torch, model):
    """Warm CUDA-event times of one SVGP value-and-grad on a batch of 4096
    and of its forward stages, at the trained values (after the main run's
    counts were read), each beside its bound: bytes each stage must move
    (float32, a triangular operand's triangle) or its operations (m³/3 for
    the Cholesky, m²·k for a triangular solve with k right-hand sides,
    2·m²·k for a product), whichever takes longer.  The forward's bound is
    the sum of its stages'; the value-and-grad's three times that, since
    the backward of a solve or a product is two of the same size and the
    Gram's and the factor's backward at least twice theirs."""
    from gptorch_tpu_torch.functions import cholesky, trtrs
    from gptorch_tpu_torch.models.sparse_gpr import draw_minibatch

    m, b, d = SP_M, SP_BATCH, SP_D
    gen = torch.Generator(device="cuda").manual_seed(1)

    def value_and_grad():
        model.zero_grad(set_to_none=True)
        model._loss(generator=gen).backward()

    vg_ms = time_ms(value_and_grad, 20)
    fwd_ms = time_ms(lambda: model._loss(generator=gen), 20)
    model.zero_grad(set_to_none=True)
    with torch.no_grad():
        z = model.Z.value
        xb, yb = draw_minibatch(gen, model.X, model.Y, b)
        Kuu = model._kuu(z)
        L = cholesky(Kuu)
        Kuf = model.kernel.K(z, xb)
        alpha = trtrs(Kuf, L)
        beta = trtrs(model.induced_output_chol_cov.value, L)
        tri = m * m / 2
        stages = {
            "draw_minibatch (randperm + gather)": (
                lambda: draw_minibatch(gen, model.X, model.Y, b), bound_ms((b * (d + 1) * 2) * 4 + b * 8, 0,
                                                                           "float32")),
            "Kuu = K(Z) (rbf_gram, symmetric)": (lambda: model._kuu(z), gram_bound_ms(m, m, d, True, "float32", 4)),
            "cholesky(Kuu) (fixed jitter)": (lambda: cholesky(Kuu), bound_ms(2 * tri * 4, m ** 3 / 3, "float32")),
            "Kuf = K(Z, xb) (rbf_gram, cross)": (lambda: model.kernel.K(z, xb),
                                                 gram_bound_ms(m, b, d, False, "float32", 4)),
            "alpha = L^-1 Kuf (trsm)": (lambda: trtrs(Kuf, L), bound_ms((tri + 2 * m * b) * 4, m * m * b, "float32")),
            "beta = L^-1 Lq (trsm)": (lambda: trtrs(model.induced_output_chol_cov.value, L),
                                      bound_ms((3 * m * m) * 4, m ** 3, "float32")),
            "gamma = beta^T alpha (gemm)": (lambda: beta.T @ alpha,
                                            bound_ms((m * m + 2 * m * b) * 4, 2 * m * m * b, "float32")),
        }
        times = {name: (time_ms(fn, 20), *bound) for name, (fn, bound) in stages.items()}
        del Kuu, L, Kuf, alpha, beta
    fwd_bound = sum(bound for _, bound, _ in times.values())
    times = {"value_and_grad (loss + backward)": (vg_ms, 3 * fwd_bound,
                                                  "3 x the forward's: each stage's backward does twice its work"),
             "forward (loss)": (fwd_ms, fwd_bound, "sum of the stages below"), **times}
    for name, (ms, bound, by) in times.items():
        print(f"# svgp stage {name}: {ms:.4f} ms (bound {bound:.4f} ms, {by})", flush=True)
    return times


def svgp_full_batch_agreement(torch, model):
    """The full-batch ELBO (n = 45730) and its gradient in float32 against the
    same computation in float64 on the card, at the trained values.
    Tolerance 4·u·√κ·√n (u the float32 unit roundoff, κ the condition
    number of Kuu + jitter from float64 eigenvalues, n the data): the ELBO
    reaches Kuu only through its Cholesky factor L (solves L⁻¹Kuf, L⁻¹L_q,
    L⁻¹m and log|L|), whose condition number is √κ, so those carry relative
    errors of a few u·√κ; the ELBO and its gradient sum n such terms, whose
    rounding errors grow like √n when they behave as random."""
    from gptorch_tpu_torch.module import get_trainable

    results = {}
    for dtype in (torch.float32, torch.float64):
        model.to(dtype)
        model.zero_grad(set_to_none=True)
        loss = model.loss(x=model.X, y=model.Y)
        loss.backward()
        raws = get_trainable(model)
        results[dtype] = (float(loss.detach()), np.concatenate([raws[k].grad.double().cpu().numpy().ravel()
                                                                for k in sorted(raws)]))
        del loss
        if dtype == torch.float64:
            with torch.no_grad():
                eig = torch.linalg.eigvalsh(model._kuu(model.Z.value))
                kappa = float(eig[-1] / eig[0])
    model.zero_grad(set_to_none=True)
    model.to(torch.float32)
    torch.cuda.empty_cache()
    tol = 4 * F32_UNIT_ROUNDOFF * math.sqrt(kappa) * math.sqrt(SP_N)
    (v32, g32), (v64, g64) = results[torch.float32], results[torch.float64]
    value_rel = abs(v32 - v64) / abs(v64)
    grad_rel = float(np.abs(g32 - g64).max() / np.abs(g64).max())
    print(f"# svgp full-batch f32 vs f64 at n={SP_N}: -ELBO {v32!r} vs {v64!r} (rel {value_rel:.3e}); gradient "
          f"max|g32-g64|/max|g64| = {grad_rel:.3e}; kappa(Kuu) = {kappa:.1f}, tol 4*u*sqrt(kappa*n) = {tol:.3e}",
          flush=True)
    check(value_rel <= tol, f"svgp f32 vs f64 ELBO {value_rel} > {tol}")
    check(grad_rel <= tol, f"svgp f32 vs f64 gradient {grad_rel} > {tol}")
    return {"elbo_f32": v32, "elbo_f64": v64, "value_rel": value_rel, "grad_rel": grad_rel, "kappa": kappa,
            "tol": tol}


def sparse_serving_phase(torch, gram, contract, svgp, kind):
    """``posterior()`` -> ``for_serving()`` -> 8 batches of 256 queries for
    the trained SVGP, or (``kind="vfe"``) a VFE on all n = 45730 points
    sharing its kernel, likelihood and inducing inputs; the serving moments
    against the triangular-solve posterior's.  For VFE, also one warm
    value-and-grad of the collapsed bound at full n."""
    from gptorch_tpu_torch import settings
    from gptorch_tpu_torch.models import VFE

    _, _, xq = make_data(SP_N, SP_D, np.float32, seed=3)
    out = {"kind": kind, "n": SP_N, "m": SP_M, "q": Q, "batches": BATCHES}
    with settings.override(jitter_policy="fixed"):
        if kind == "vfe":
            model = VFE(svgp.X, svgp.Y, svgp.kernel, inducing_points=svgp.Z.value.detach(),
                        likelihood=svgp.likelihood, jitter=SP_JITTER)
        else:
            model = svgp
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        post = model.posterior()
        torch.cuda.synchronize()
        out["factorize_ms"] = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        serving = post.for_serving()
        torch.cuda.synchronize()
        out["convert_ms"] = 1e3 * (time.perf_counter() - t0)
        predict_ms, means, variances = [], [], []
        for xb in xq:
            t0 = time.perf_counter()
            mu, var = serving.predict_f(xb)
            predict_ms.append(1e3 * (time.perf_counter() - t0))
            means.append(mu), variances.append(var)
        out["launches"] = read_counts()
        out["predict_f_ms"] = predict_ms
        check(out["launches"]["rbf_gram"] > 0, f"the {kind} serving path never launched rbf_gram")
        mu, var = np.concatenate(means), np.concatenate(variances)
        check(np.isfinite(mu).all() and np.isfinite(var).all(), f"non-finite {kind} serving output")
        check(mu.shape == (Q * BATCHES, 1) and var.shape == mu.shape, f"wrong {kind} serving output shape")
        ref = [post.predict_f(xb) for xb in xq]
        ref_mu, ref_var = np.concatenate([r[0] for r in ref]), np.concatenate([r[1] for r in ref])
        out["serving_vs_trtrs"] = {"mean_max_abs": float(np.abs(mu - ref_mu).max()),
                                   "var_max_abs": float(np.abs(var - ref_var).max()), "tol": SERVING_TOL}
        out["trtrs_predict_f_ms"] = time_ms(lambda: post.predict_f(xq[0]), 20)
        out["serving_predict_f_warm_ms"] = time_ms(lambda: serving.predict_f(xq[0]), 20)
        if kind == "vfe":
            def value_and_grad():
                model.zero_grad(set_to_none=True)
                model._loss().backward()

            out["vfe_value_and_grad_ms"] = time_ms(value_and_grad, 5)
            model.zero_grad(set_to_none=True)
    agree = out["serving_vs_trtrs"]
    extra = (f", VFE value-and-grad at n={SP_N} {out['vfe_value_and_grad_ms']:.3f} ms" if kind == "vfe" else "")
    print(f"# {kind} serving n={SP_N} m={SP_M} f32: factorize {out['factorize_ms']:.3f} ms, convert "
          f"{out['convert_ms']:.3f} ms, predict_f per batch of {Q} median {np.median(predict_ms):.4f} ms "
          f"(warm, CUDA events: serving {out['serving_predict_f_warm_ms']:.4f} ms, trtrs posterior "
          f"{out['trtrs_predict_f_ms']:.4f} ms), launches {out['launches']}; serving vs trtrs max abs: mean "
          f"{agree['mean_max_abs']:.3e}, var {agree['var_max_abs']:.3e} (tol {SERVING_TOL}){extra}", flush=True)
    for key in ("mean_max_abs", "var_max_abs"):
        check(agree[key] <= SERVING_TOL, f"{kind} serving vs trtrs {key} {agree[key]} > {SERVING_TOL}")
    return out


def sparse_card_vs_cpu(torch, gram, contract):
    """n = 4096, m = 256 in float64: SVGP in both parameterizations (loss and
    gradient on one explicit batch of 1024), VFE and FITC (full data), and
    one natural-gradient step, on the card against the CPU's plain route,
    to 1e-8 relative (gradients and parameters relative to their largest
    entry)."""
    from gptorch_tpu_torch import kernels, likelihoods, settings
    from gptorch_tpu_torch.models import FITC, SVGP, VFE
    from gptorch_tpu_torch.module import get_trainable
    from gptorch_tpu_torch.training import natgrad

    n, m, b = 4096, 256, 1024
    x, y, z = sparse_data(n, SP_D, m, np.float64, seed=4)
    ell = np.linspace(0.8, 1.6, SP_D)
    common = dict(inducing_points=z, jitter=SP_JITTER)
    makers = {
        "svgp": lambda dev: SVGP(x, y, kernels.Rbf(SP_D, ARD=True, length_scales=ell), device=dev, **common),
        "svgp whitened": lambda dev: SVGP(x, y, kernels.Rbf(SP_D, ARD=True, length_scales=ell), whiten=True,
                                          device=dev, **common),
        "vfe": lambda dev: VFE(x, y, kernels.Rbf(SP_D, ARD=True, length_scales=ell),
                               likelihood=likelihoods.Gaussian(0.1), device=dev, **common),
        "fitc": lambda dev: FITC(x, y, kernels.Rbf(SP_D, ARD=True, length_scales=ell),
                                 likelihood=likelihoods.Gaussian(0.1), device=dev, **common),
    }
    out = {}
    with default_dtype(torch, torch.float64), settings.override(jitter_policy="fixed"):
        for name, make in {**makers, "natgrad step (svgp)": makers["svgp"]}.items():
            res = {}
            for device in ("cuda", "cpu"):
                model = make(device)
                zero_counts()
                raws = get_trainable(model)
                if name.startswith("natgrad"):
                    step, _ = natgrad.make_natgrad_step(model, nat_lr=0.5)
                    value = float(step())
                    vec = np.concatenate([raws[k].detach().cpu().numpy().ravel() for k in sorted(raws)])
                else:
                    batch = (model.X[:b], model.Y[:b]) if name.startswith("svgp") else (None, None)
                    loss = model.loss(*batch)
                    loss.backward()
                    value = float(loss.detach())
                    vec = np.concatenate([raws[k].grad.cpu().numpy().ravel() for k in sorted(raws)])
                res[device] = (value, vec, read_counts())
                del model, raws
            value_rel = abs(res["cuda"][0] - res["cpu"][0]) / abs(res["cpu"][0])
            vec_rel = float(np.abs(res["cuda"][1] - res["cpu"][1]).max() / np.abs(res["cpu"][1]).max())
            what = "parameters after the step" if name.startswith("natgrad") else "gradient"
            print(f"# sparse f64 card vs CPU n={n} m={m} {name}: loss rel {value_rel:.3e}, {what} rel "
                  f"{vec_rel:.3e} (tol {F64_REL_TOL}), card launches {res['cuda'][2]}", flush=True)
            check(res["cuda"][2]["rbf_gram"] >= 2, f"{name}: the card route launched rbf_gram {res['cuda'][2]}")
            check(not any(res["cpu"][2].values()), f"{name}: the CPU launched")
            check(value_rel <= F64_REL_TOL, f"{name}: loss card vs CPU {value_rel} > {F64_REL_TOL}")
            check(vec_rel <= F64_REL_TOL, f"{name}: {what} card vs CPU {vec_rel} > {F64_REL_TOL}")
            out[name] = {"value_rel": value_rel, "vec_rel": vec_rel, "launches": res["cuda"][2]}
    torch.cuda.empty_cache()
    return out


def svgp_captured_phase(torch, gram, contract, captured):
    """The SVGP cell (as in :func:`svgp_training_phase`) trained from one
    generator seed by the eager loop (``fit._fit_scan(..., capture=False)``,
    the loop a captured run is held against) and by ``fit_scan``'s captured
    graph, on two fresh models, SP_STEPS Adam steps each.  Every batch's
    indices are recorded on the card (a wrapper of
    ``sparse_gpr.minibatch_indices`` that the capture records too) and must
    be identical, and each step's loss must agree within CAPTURE_RTOL (or be
    bitwise equal).  Then the eager loop's ms/step, busy ms and idle share
    on a fresh model, beside the captured numbers of ``captured`` (the
    svgp_training phase's)."""
    from gptorch_tpu_torch import kernels, settings
    from gptorch_tpu_torch.models import SVGP, sparse_gpr
    from gptorch_tpu_torch.training import fit

    x, y, z = sparse_data(SP_N, SP_D, SP_M, np.float32)

    def make():
        return SVGP(x, y, kernels.Rbf(SP_D, ARD=True), inducing_points=z, batch_size=SP_BATCH, jitter=SP_JITTER)

    rows = SP_STEPS + 1  # the captured run's warm-up step writes a row first
    original = sparse_gpr.minibatch_indices
    runs = {}
    with settings.override(jitter_policy="fixed"):
        for mode in ("eager", "captured"):
            rec = torch.full((rows, SP_BATCH), -1, dtype=torch.long, device="cuda")
            count = torch.zeros((1,), dtype=torch.long, device="cuda")

            def recording(generator, n, batch_size, device, rec=rec, count=count):
                idx = original(generator, n, batch_size, device)
                rec.index_copy_(0, torch.remainder(count, rows), idx[None])
                count.add_(1)
                return idx

            sparse_gpr.minibatch_indices = recording
            try:
                model = make()
                gen = torch.Generator(device="cuda").manual_seed(0)
                _, losses = fit._fit_scan(model, "Adam", SP_STEPS, SP_LR, gen, capture=mode == "captured")
                torch.cuda.synchronize()
            finally:
                sparse_gpr.minibatch_indices = original
            check(fit.fit_scan.last_run["captured"] == (mode == "captured"), f"svgp_captured: {mode} run")
            batches = rec[1:] if mode == "captured" else rec[:SP_STEPS]
            runs[mode] = (losses.cpu().numpy().astype(np.float64), batches.cpu(), gen.get_state())
            del model
        (l_e, b_e, g_e), (l_c, b_c, g_c) = runs["eager"], runs["captured"]
        same_batches = bool(torch.equal(b_e, b_c)) and bool((b_e >= 0).all())
        bitwise = bool(np.array_equal(l_e, l_c))
        rel = float(np.max(np.abs(l_c - l_e) / np.abs(l_e)))
        out = {"steps": SP_STEPS, "identical_batches": same_batches, "generator_states_equal": bool(torch.equal(g_e, g_c)),
               "losses_bitwise_equal": bitwise, "losses_max_rel": rel, "tol": CAPTURE_RTOL}

        # the eager loop's speed on a fresh model (no recorder)
        model = make()
        gen = torch.Generator(device="cuda").manual_seed(0)
        fit._fit_scan(model, "Adam", SP_STEPS, SP_LR, gen, capture=False)
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        fit._fit_scan(model, "Adam", SP_STEPS, SP_LR, gen, capture=False)
        torch.cuda.synchronize()
        out["eager_step_ms"] = 1e3 * (time.perf_counter() - t0) / SP_STEPS
        eager_counts = read_counts()
        _, busy, _, _ = device_busy_ms(torch, lambda: fit._fit_scan(model, "Adam", SP_STEPS, SP_LR, gen, capture=False))
        out["eager_device_ms_per_step"] = busy / SP_STEPS
        out["eager_idle_share"] = 1.0 - out["eager_device_ms_per_step"] / out["eager_step_ms"]
        del model
    out["captured_step_ms"] = captured["step_ms"]
    out["captured_device_ms_per_step"] = captured["device_ms_per_step"]
    out["captured_idle_share"] = captured["idle_share"]
    out["eager_launches_per_step"] = {k: v / SP_STEPS for k, v in eager_counts.items()}
    out["captured_launches_per_step"] = captured["launches_per_captured_step"]
    out["launches"] = add_counts(eager_counts, {k: v * SP_STEPS for k, v in out["captured_launches_per_step"].items()})
    print(f"# svgp_captured n={SP_N} m={SP_M} batch={SP_BATCH} f32 Adam, {SP_STEPS} steps from seed 0: batches "
          f"identical {same_batches}, generator states equal {out['generator_states_equal']}, losses bitwise equal "
          f"{bitwise}, max rel {rel:.3e} (tol {CAPTURE_RTOL}); eager {out['eager_step_ms']:.4f} ms/step, busy "
          f"{out['eager_device_ms_per_step']:.4f} ms/step, idle share {out['eager_idle_share']:.3f}, K1 launches "
          f"{out['eager_launches_per_step']['rbf_gram']:.0f}/step from the host; captured {out['captured_step_ms']:.4f} "
          f"ms/step, busy {out['captured_device_ms_per_step']:.4f} ms/step, idle share "
          f"{out['captured_idle_share']:.3f}, K1 launches {out['captured_launches_per_step']['rbf_gram']}/step "
          f"recorded in the graph x {SP_STEPS} replays", flush=True)
    check(same_batches, "svgp_captured: the captured run drew other minibatches than the eager run")
    check(out["generator_states_equal"], "svgp_captured: the generators ended in different states")
    check(bitwise or rel <= CAPTURE_RTOL, f"svgp_captured: losses differ by {rel} > {CAPTURE_RTOL}")
    check(out["captured_launches_per_step"]["rbf_gram"] > 0 and eager_counts["rbf_gram"] > 0,
          "svgp_captured: rbf_gram was not launched")
    return out


def dkl_studentt_svgp_phase(torch, gram, contract):
    """Robust deep kernel learning at the sparse cell: SVGP(n = 45730,
    d = 9, m = 1024 inducing points in input space, batch 4096,
    DeepKernel(Rbf(2, ARD), MLP([9, 64, 64, 2])), StudentT(df = 4), jitter
    DKL_JITTER, float32; built under the adaptive policy, trained under the
    fixed one), ``fit_scan`` Adam lr 1e-2 (a warm call
    and a timed call of SP_STEPS, captured), then ``for_serving()`` and
    ``predict_f`` on 256 queries; then the full-batch ELBO and gradient in
    float64 at n = 4096, m = 128, card against CPU."""
    from gptorch_tpu_torch import kernels, likelihoods, nn, settings
    from gptorch_tpu_torch.models import SVGP
    from gptorch_tpu_torch.module import get_trainable

    x, y, z = sparse_data(SP_N, SP_D, SP_M, np.float32)
    _, _, xq = make_data(SP_N, SP_D, np.float32, seed=3)

    def make(x, y, z, device=None):
        kern = kernels.DeepKernel(kernels.Rbf(2, ARD=True), nn.MLP(DKL_WIDTHS))
        return SVGP(x, y, kern, inducing_points=z, likelihood=likelihoods.StudentT(df=DKL_DF), batch_size=SP_BATCH,
                    jitter=DKL_JITTER, device=device)

    out = {"n": SP_N, "m": SP_M, "batch": SP_BATCH, "widths": DKL_WIDTHS, "df": DKL_DF, "steps": SP_STEPS,
           "jitter": DKL_JITTER}
    model = make(x, y, z)
    with settings.override(jitter_policy="fixed"):
        gen = torch.Generator(device="cuda").manual_seed(0)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        warm = model.fit_scan("Adam", max_iter=SP_STEPS, learning_rate=SP_LR, generator=gen)
        torch.cuda.synchronize()
        out["warm_call_s"] = time.perf_counter() - t0
        out["launches_per_captured_step"] = check_captured("dkl_studentt_svgp")
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9  # the warm-up step's and the capture's
        zero_counts()
        t0 = time.perf_counter()
        losses = model.fit_scan("Adam", max_iter=SP_STEPS, learning_rate=SP_LR, generator=gen)
        torch.cuda.synchronize()
        out["step_ms"] = 1e3 * (time.perf_counter() - t0) / SP_STEPS
        replayed = replayed_launches()
        out["losses"] = [float(v) for v in torch.cat([warm, losses]).cpu()]
        t0 = time.perf_counter()
        serving = model.posterior().for_serving()
        torch.cuda.synchronize()
        out["serving_setup_ms"] = 1e3 * (time.perf_counter() - t0)
        mu, var = serving.predict_f(xq[0])
        out["predict_f_ms"] = time_ms(lambda: serving.predict_f(xq[0]), 10)
        out["launches"] = add_counts(read_counts(), replayed)
        del model, serving
    first, last = np.mean(out["losses"][:10]), np.mean(out["losses"][-10:])
    print(f"# dkl_studentt_svgp n={SP_N} d={SP_D} m={SP_M} batch={SP_BATCH} f32 DeepKernel(Rbf(2), MLP({DKL_WIDTHS})) "
          f"StudentT(df={DKL_DF}) fit_scan Adam lr={SP_LR} (captured CUDA graph, launches recorded per captured step "
          f"{out['launches_per_captured_step']}): warm call {out['warm_call_s']:.3f} s, timed {out['step_ms']:.4f} "
          f"ms/step, peak {out['peak_mem_gb']:.3f} GB; losses first 10 mean {first:.4f}, last 10 mean {last:.4f}; "
          f"serving set-up {out['serving_setup_ms']:.2f} ms, predict_f per {Q} {out['predict_f_ms']:.4f} ms "
          f"(CUDA events); launches {out['launches']}", flush=True)
    check(all(math.isfinite(v) for v in out["losses"]), "non-finite DKL training loss")
    check(last < first, "DKL training did not lower the loss")
    check(np.isfinite(mu).all() and np.isfinite(var).all() and mu.shape == (Q, 1) and (var > 0).all(),
          "bad DKL serving output")
    check(out["launches"]["rbf_gram"] > 0, "the DKL path never launched rbf_gram")

    xc, yc, zc = sparse_data(DKL_CHECK_N, SP_D, DKL_CHECK_M, np.float64, seed=5)
    res = {}
    with default_dtype(torch, torch.float64):
        for device in ("cuda", "cpu"):
            m = make(xc, yc, zc, device)
            with settings.override(jitter_policy="fixed"):
                loss = m.loss(x=m.X, y=m.Y)
            loss.backward()
            raws = get_trainable(m)
            res[device] = (float(loss.detach()), np.concatenate([raws[k].grad.cpu().numpy().ravel()
                                                                 for k in sorted(raws)]))
            del m, loss, raws
    value_rel = abs(res["cuda"][0] - res["cpu"][0]) / abs(res["cpu"][0])
    grad_rel = float(np.abs(res["cuda"][1] - res["cpu"][1]).max() / np.abs(res["cpu"][1]).max())
    out["card_vs_cpu"] = {"value_rel": value_rel, "grad_rel": grad_rel, "tol": F64_REL_TOL}
    print(f"# dkl_studentt_svgp f64 card vs CPU n={DKL_CHECK_N} m={DKL_CHECK_M}: -ELBO rel {value_rel:.3e}, "
          f"gradient rel {grad_rel:.3e} (tol {F64_REL_TOL})", flush=True)
    check(value_rel <= F64_REL_TOL and grad_rel <= F64_REL_TOL, "DKL card vs CPU disagree")
    torch.cuda.empty_cache()
    return out


def zoo_gram_cases(kernels, nn, d):
    """The eleven kernels of the zoo at width d, with the input each takes
    ("x": the data; "fidelity": the data with a level column; "line": its
    first column; "task": a column of task ids); the wrappers wrap Rbf."""
    return [
        ("Periodic", kernels.Periodic(d, length_scales=2.0), "x"),
        ("ExpSinSquared(ARD)", kernels.ExpSinSquared(d, length_scales=np.linspace(0.8, 1.6, d), period=2.0,
                                                      ARD=True), "x"),
        ("SpectralMixture(Q=4)", kernels.SpectralMixture(d, ZOO_MIXTURES,
                                                         means=0.1 + 0.02 * np.arange(4 * d).reshape(4, d),
                                                         scales=0.2 + 0.01 * np.arange(4 * d).reshape(4, d)), "x"),
        ("ActiveDims(Rbf(4))", kernels.ActiveDims(kernels.Rbf(4, ARD=True), [0, 2, 4, 6], d), "x"),
        ("DeepKernel(Rbf(2), MLP([8, 64, 64, 2]))", kernels.DeepKernel(kernels.Rbf(2, ARD=True),
                                                                       nn.MLP([d, 64, 64, 2])), "x"),
        ("InputWarp(Rbf)", kernels.InputWarp(kernels.Rbf(d, ARD=True), a=0.8, b=1.3, lo=-5.0, hi=5.0), "x"),
        ("MultiFidelity(Rbf, Rbf)", kernels.MultiFidelity([kernels.Rbf(d), kernels.Rbf(d, length_scales=2.0)],
                                                          rho=0.6), "fidelity"),
        ("Cosine", kernels.Cosine(d, length_scales=3.0), "x"),
        ("ArcCosine(1)", kernels.ArcCosine(d, order=1), "x"),
        ("ChangePoints(Rbf, Rbf)", kernels.ChangePoints([kernels.Rbf(1), kernels.Rbf(1, length_scales=0.5)], [0.0]),
         "line"),
        ("Coregion(4, rank 2)", kernels.Coregion(4, rank=2), "task"),
    ]


def zoo_input(torch, kind, x):
    if kind == "fidelity":
        return torch.cat([x, (torch.arange(x.shape[0], device=x.device) % 2).to(x.dtype)[:, None]], dim=1)
    if kind == "line":
        return x[:, :1].contiguous()
    if kind == "task":
        return (torch.arange(x.shape[0], device=x.device) % 4).to(x.dtype)[:, None]
    return x


def zoo_grams_phase(torch, gram, contract):
    """The eleven new kernels' Grams at (32768, 32768), d = 8, float32, on
    bench.py's data: warm CUDA-event ms, peak device memory and the bound
    (the n² output written once at 3.35 TB/s); each held against the CPU in
    float64 at (2048, 2048) within F64_REL_TOL's 1e-10 scale."""
    import copy

    from gptorch_tpu_torch import kernels, nn

    x, _, _ = make_data(N, D, np.float32)
    xt = torch.as_tensor(x, device="cuda")
    rows, counts = [], []
    bound, bound_by = bound_ms(N * N * 4, 0, "float32")
    for name, kern, kind in zoo_gram_cases(kernels, nn, D):
        kern = kern.to("cuda")
        a = zoo_input(torch, kind, xt)
        with torch.no_grad():
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            ms = time_ms(lambda: kern.K(a), 2)
            counts.append(read_counts())
            peak = torch.cuda.max_memory_allocated() / 1e9
            k64 = copy.deepcopy(kern).double()
            a64 = a[:ZOO_GRAM_CHECK_N].double()
            card = k64.K(a64).cpu()
            cpu = copy.deepcopy(k64).cpu().K(a64.cpu())
        rel = float((card - cpu).abs().max() / cpu.abs().max())
        rows.append({"kernel": name, "ms": ms, "peak_gb": peak, "bound_ms": bound, "bound_by": bound_by,
                     "f64_card_vs_cpu_rel": rel, "k1_launches": counts[-1]["rbf_gram"]})
        print(f"# zoo gram {name} ({N}, {N}) d={D} f32: {ms:.3f} ms (bound {bound:.3f} ms, {bound_by}; "
              f"{ms / bound:.1f}x), peak {peak:.2f} GB, K1 launches {counts[-1]['rbf_gram']}; f64 card vs CPU at "
              f"({ZOO_GRAM_CHECK_N}, {ZOO_GRAM_CHECK_N}) rel {rel:.3e} (tol 1e-10)", flush=True)
        check(rel <= 1e-10, f"zoo gram {name}: f64 card vs CPU {rel} > 1e-10")
        del kern, a, k64, a64, card, cpu
        torch.cuda.empty_cache()
    return {"grams": rows, "launches": add_counts(*counts)}


def zoo_kernel(kernels, x, y):
    """The pattern-discovery composite: Rbf(ARD)·ExpSinSquared(ARD) +
    SpectralMixture(Q = 4) started by ``spectral_mixture_init``."""
    d = x.shape[1]
    return (kernels.Rbf(d, ARD=True) * kernels.ExpSinSquared(d, ARD=True)
            + kernels.spectral_mixture_init(x, y, ZOO_MIXTURES))


def zoo_model(n, dtype, device=None):
    """GPR on bench.py's data (n points, d = 8, seed 0) with
    :func:`zoo_kernel`, Gaussian(0.1) and fast_jitter 1e-3: the
    kernel-general path.  Returns (model, query batches)."""
    from gptorch_tpu_torch import kernels, likelihoods
    from gptorch_tpu_torch.models import GPR

    x, y, xq = make_data(n, D, dtype)
    model = GPR(x, y, zoo_kernel(kernels, x, y), likelihood=likelihoods.Gaussian(0.1), fast_jitter=TRAIN_JITTER,
                device=device)
    return model, xq


def zoo_check_run(torch, model):
    """At the model's start, the loss and gradient; then ZOO_CHECK_ITERS
    iterations of the L-BFGS optimizer that ``fit_scan("LBFGS")`` runs,
    stepped here so that each iterate's raw values are kept.  Returns
    (loss, gradient vector, the loss after each iteration, the iterates)."""
    from gptorch_tpu_torch.module import get_trainable, trainable_parameters
    from gptorch_tpu_torch.training import fit

    model.zero_grad(set_to_none=True)
    loss = model.loss()
    loss.backward()
    raws = get_trainable(model)
    grad = np.concatenate([raws[k].grad.double().cpu().numpy().ravel() for k in sorted(raws)])
    model.zero_grad(set_to_none=True)
    opt = fit.make_optimizer("LBFGS", trainable_parameters(model))
    closure = fit._fixed_objective(model, opt, torch.Generator(device=model.device).manual_seed(0))
    losses, iterates = [], []
    for _ in range(ZOO_CHECK_ITERS):
        opt.step(closure)
        losses.append(opt.last[0])  # the line search's value at the new iterate
        iterates.append({k: v.detach().cpu().numpy().tolist() for k, v in get_trainable(model).items()})
    return float(loss.detach()), grad, losses, iterates


def zoo_cpu_reference(path):
    """The CPU side of zoo_training's float64 check at ZOO_CHECK_N: the loss
    and gradient at the start, and the loss at each L-BFGS iterate the card
    reached (read from ``path + ".in"``), written to ``path`` as JSON.  Run
    by a background process of this script (``--zoo-cpu-reference PATH``)
    while the card trains at full n."""
    import torch

    from gptorch_tpu_torch.module import get_trainable, set_trainable

    torch.set_num_threads(max(1, (os.cpu_count() or 2) - 1))  # the card's host thread keeps one core
    with open(path + ".in") as f:
        iterates = json.load(f)
    with default_dtype(torch, torch.float64):
        model, _ = zoo_model(ZOO_CHECK_N, np.float64, "cpu")
        loss = model.loss()
        loss.backward()
        raws = get_trainable(model)
        grad = np.concatenate([raws[k].grad.numpy().ravel() for k in sorted(raws)])
        losses = []
        with torch.no_grad():
            for values in iterates:
                set_trainable(model, {k: np.asarray(v) for k, v in values.items()})
                losses.append(float(model.loss()))
    with open(path, "w") as f:
        json.dump({"loss": float(loss.detach()), "grad": grad.tolist(), "losses": losses}, f)
    return 0


def start_reference(flag, name, inputs=None):
    """Start this script as ``chip_smoke.py FLAG PATH`` in a background
    process with no card (``CUDA_VISIBLE_DEVICES`` empty), PATH the file
    ``name`` of a new temporary directory, after writing ``inputs`` (if
    any) as JSON to PATH + ".in"; returns (process, PATH, log path)."""
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    path, log = os.path.join(workdir, name), os.path.join(workdir, name + ".log")
    if inputs is not None:
        with open(path + ".in", "w") as f:
            json.dump(inputs, f)
    with open(log, "w") as f:
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), flag, path],
                                stdout=f, stderr=subprocess.STDOUT, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    return proc, path, log


def zoo_stages(torch, model):
    """Warm CUDA-event times of the composite Gram K(X) and of the chunked
    kernel VJP of the general path's backward (K(X_R, X) rebuilt under
    autograd per chunk of ``gpr_general.chunk_rows`` rows, differentiated
    against a cotangent chunk), with their peak memory, each beside its
    bound: the n² float32 output (or cotangent) moved once, or per Gram
    entry 10d + 8 + Q(8d + 5) operations (Rbf 3d + 3, ExpSinSquared(ARD)
    7d + 3, SpectralMixture 8d + 5 per component, the product and the sum
    one each; a sine, cosine or exponential counted as one), three times
    that for the VJP (the rebuild and a backward of at least twice its
    work), at 67 TFLOP/s."""
    from gptorch_tpu_torch.module import trainable_parameters
    from gptorch_tpu_torch.ops import gpr_general

    kernel, X = model.kernel, model.X
    params = trainable_parameters(kernel)
    ops_per_entry = 10 * D + 8 + ZOO_MIXTURES * (8 * D + 5)
    out = {}
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(lambda: kernel.K(X), 2)
        out["gram"] = (ms, *bound_ms((N * D + N * N) * 4, N * N * ops_per_entry, "float32"),
                       torch.cuda.max_memory_allocated() / 1e9)
    rows = gpr_general.chunk_rows(kernel, X)
    cot = torch.full((rows, N), 1e-3, device="cuda", dtype=X.dtype)

    def chunked_vjp():
        for lo, hi in gpr_general._chunk_bounds(N, rows):
            torch.autograd.grad(kernel.K(X[lo:hi], X), params, grad_outputs=cot[: hi - lo])

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(chunked_vjp, 1)
    out["chunked_vjp"] = (ms, *bound_ms((N * D + N * N) * 4, 3 * N * N * ops_per_entry, "float32"),
                          torch.cuda.max_memory_allocated() / 1e9)
    del cot
    torch.cuda.empty_cache()
    for name, (ms, bound, by, peak) in out.items():
        print(f"# zoo stage {name}: {ms:.3f} ms (bound {bound:.3f} ms, {by}; {ms / bound:.1f}x), peak {peak:.2f} GB"
              + (f", {rows}-row chunks" if name == "chunked_vjp" else ""), flush=True)
    out["chunk_rows"] = rows
    return out


def start_zoo_check(torch):
    """The card's side of zoo_training's float64 check at ZOO_CHECK_N (the
    loss, gradient and ZOO_CHECK_ITERS L-BFGS iterations), then
    :func:`zoo_cpu_reference` started on its iterates in the background:
    returns (the card's readings, process, result path, log path)."""
    with default_dtype(torch, torch.float64):
        model, _ = zoo_model(ZOO_CHECK_N, np.float64)
        card = zoo_check_run(torch, model)
        del model
    torch.cuda.empty_cache()
    return (card, *start_reference("--zoo-cpu-reference", "zoo_cpu.json", card[3]))


def zoo_training_phase(torch, gram, contract):
    """Pattern discovery at bench.py's scale: GPR(n = 32768, d = 8,
    float32) with :func:`zoo_kernel` on the kernel-general path, trained by
    ``fit_scan(method="LBFGS", max_iter=ZOO_LBFGS_ITERS)`` (eager, host
    reads per evaluation), then ``posterior().predict_f`` on 256 queries;
    the Gram's and the chunked VJP's times."""
    from gptorch_tpu_torch import settings
    from gptorch_tpu_torch.training import fit

    model, xq = zoo_model(N, np.float32)
    check(model._general_eligible(model.X) and not model._fast_eligible(model.X),
          "the zoo model is not on the kernel-general path")
    out = {"n": N, "d": D, "dtype": "float32", "kernel": "Rbf(ARD)*ExpSinSquared(ARD) + SpectralMixture(Q=4)",
           "iterations": ZOO_LBFGS_ITERS}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    losses = model.fit_scan("LBFGS", max_iter=ZOO_LBFGS_ITERS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out["launches"] = read_counts()
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["evaluations"] = list(fit.fit_scan.last_run["evaluations"])
    out["lbfgs_s"] = wall
    out["ms_per_evaluation"] = 1e3 * wall / sum(out["evaluations"])
    out["losses"] = [float(v) for v in losses.cpu()]
    with settings.override(jitter_policy="fixed"):
        t0 = time.perf_counter()
        post = model.posterior()
        mu, var = post.predict_f(xq[0])
        out["posterior_predict_s"] = time.perf_counter() - t0
        del post
    torch.cuda.empty_cache()
    print(f"# zoo training n={N} d={D} f32 {out['kernel']} fit_scan LBFGS max_iter={ZOO_LBFGS_ITERS} (eager: "
          f"host reads per evaluation): {out['lbfgs_s']:.3f} s, evaluations per iteration {out['evaluations']}, "
          f"{out['ms_per_evaluation']:.1f} ms per evaluation, losses {out['losses']}, peak device memory "
          f"{out['peak_mem_gb']:.2f} GB (limit {ZOO_PEAK_GB}), launches {out['launches']}; posterior() + "
          f"predict_f of {Q}: {out['posterior_predict_s']:.3f} s", flush=True)
    check(all(math.isfinite(v) for v in out["losses"]), "non-finite zoo training loss")
    check(all(b < a for a, b in zip(out["losses"], out["losses"][1:])), "the zoo L-BFGS losses do not decrease")
    check(out["peak_mem_gb"] <= ZOO_PEAK_GB, f"zoo training peak {out['peak_mem_gb']} GB > {ZOO_PEAK_GB}")
    check(out["launches"]["rbf_gram"] > 0, "the zoo training path never launched rbf_gram")
    check(np.isfinite(mu).all() and np.isfinite(var).all() and mu.shape == (Q, 1), "bad zoo predict_f output")
    out["stages"] = zoo_stages(torch, model)
    del model
    torch.cuda.empty_cache()
    return out


def zoo_card_vs_cpu(zoo_check):
    """zoo_training's float64 check: the card's readings from
    :func:`start_zoo_check` against its background process's, to
    F64_REL_TOL."""
    card, proc, path, log = zoo_check
    t0 = time.perf_counter()
    try:
        code = proc.wait(timeout=600)
    finally:
        stop_process(proc)
    waited = time.perf_counter() - t0
    if code != 0:
        with open(log) as f:
            print(f.read(), file=sys.stderr)
    check(code == 0, f"the CPU reference process failed (exit {code})")
    with open(path) as f:
        ref = json.load(f)
    value_rel = abs(card[0] - ref["loss"]) / abs(ref["loss"])
    grad_rel = float(np.abs(card[1] - np.asarray(ref["grad"])).max() / np.abs(ref["grad"]).max())
    iter_rel = max(abs(a - b) / abs(b) for a, b in zip(card[2], ref["losses"]))
    out = {"value_rel": value_rel, "grad_rel": grad_rel, "lbfgs_losses_rel": iter_rel, "card_losses": card[2],
           "cpu_losses": ref["losses"], "tol": F64_REL_TOL, "cpu_reference_wait_s": waited}
    print(f"# zoo f64 card vs CPU n={ZOO_CHECK_N}: loss rel {value_rel:.3e}, gradient rel {grad_rel:.3e} at the "
          f"start; the losses after {ZOO_CHECK_ITERS} L-BFGS iterations on the card against the CPU's at the same "
          f"iterates rel {iter_rel:.3e} (tol {F64_REL_TOL}; card {card[2]}, CPU {ref['losses']}); waited "
          f"{waited:.1f} s for the CPU after the iterative phases", flush=True)
    check(max(value_rel, grad_rel, iter_rel) <= F64_REL_TOL, "zoo card vs CPU disagree")
    return out


def mvm_bound_ms(n, d, k, dtype, itemsize):
    """Least time for K3's function: xs and V read once, the output written
    once, and 2d + 5 + 2k operations per pair (2d + 3 for r² by the norm
    identity, as the reference computes it: a d-long dot product, two adds
    and the doubling; 2 for the scale and the exp; k fused multiply-adds),
    a fused multiply-add counted as two.  The kernel issues about d + 5
    instructions a pair plus k rounded up to 4 (csrc/radial_mvm.cu's
    note); that is its cost, not the function's."""
    return bound_ms((n * d + 2 * n * k + 3) * itemsize, n * n * (2 * d + 5 + 2 * k), dtype)


def lowrank_bound_ms(n, d, r, dtype, itemsize):
    """Least time for K4's function: xs, Wl and Wr read once, d + 2 sums
    written, and each unordered pair once (G, E and F are symmetric and
    every output is a sum over pairs, so the pair (i, j) and (j, i) share
    one visit weighted by Sᵢⱼ = Wᵢⱼ + Wⱼᵢ): n(n + 1)/2 pairs of
    4d + 4r + 11 operations (2d + 3 for r² by the norm identity, 4r for
    Sᵢⱼ, 3 for the map, 2 for svar, 1 for Sᵢⱼ·Eᵢⱼ, 2d + 2 for the
    length-scale sums by the reference's formula: M·x̃ and the row and
    column sums of M = W⊙E).  The kernel spends 3d − 1 on r² and d on the
    sums by direct differences, and 2r rounded up to 4 on Sᵢⱼ."""
    return bound_ms((n * d + 2 * n * r + 2 + d + 2) * itemsize, n * (n + 1) // 2 * (4 * d + 4 * r + 11), dtype)


def lowrank_bound_ordered_ms(n, d, r, dtype, itemsize):
    """K4's bound as it was first stated, over every ordered pair
    (4d + 2r + 11 operations each), printed beside the one over unordered
    pairs so that shares taken against it stay comparable."""
    return bound_ms((n * d + 2 * n * r + 2 + d + 2) * itemsize, n * n * (4 * d + 2 * r + 11), dtype)


def ptxas_report(log, pattern):
    """{kernel: (registers, spill stores, spill loads)} from ptxas's -v
    report in ``log``, for the kernels whose mangled name matches the
    regular expression ``pattern``."""
    out, name = {}, None
    for line in log.splitlines():
        found = re.search(r"Function properties for (\S+)", line)
        if found:
            name = found.group(1)
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        used = re.search(r"Used (\d+) registers", line)
        if name and re.search(pattern, name) and (spill or used):
            regs, stores, loads = out.get(name, (None, None, None))
            if spill:
                stores, loads = int(spill.group(1)), int(spill.group(2))
            if used:
                regs = int(used.group(1))
            out[name] = (regs, stores, loads)
    return out


def k1_instance(mangled):
    """A readable name for a K1 kernel's mangled name: its mapping, type and
    template arguments (rbf_gram_kernel_tilesIfLi128ELb1ELb0EE ->
    "tiles float32 128 rows 16-byte stores")."""
    found = re.search(r"rbf_gram_kernel_([a-z]+)I([fd])((?:L[ib]\d+E)*)E", mangled)
    if not found:
        return mangled
    mapping, t, args = found.groups()
    values = [int(v) for v in re.findall(r"L[ib](\d+)E", args)]
    words = [mapping, "float32" if t == "f" else "float64"]
    if mapping == "tiles":
        tm, vec, half = values
        words += [f"{tm} rows", "16-byte stores" if vec else "scalar stores"] + (["mirrored"] if half else [])
    elif values:
        words += [f"rows in registers to d = {values[0]}" if values[0] else "rows read per element"]
    return " ".join(words)


def radial_inputs(torch, n, cols, dtype, seed):
    """Scaled inputs x̃ (n, D), a (n, cols) block, log σ² and rq's log α on
    the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    xs = torch.randn(n, D, generator=g, device="cuda", dtype=dtype) / 1.1
    V = torch.randn(n, cols, generator=g, device="cuda", dtype=dtype)
    return xs, V, torch.tensor(math.log(1.3), device="cuda", dtype=dtype), torch.tensor([math.log(0.7)],
                                                                                        device="cuda", dtype=dtype)


def mvm_error(torch, mvm, got, kind, xs, log_var, noise, V, log_extra):
    """(max |kernel − twin| / scale, max abs) with the twin in float64."""
    args = (xs.double(), log_var.double(), noise)
    ref = mvm.gram_mvm_plain(kind, *args, V.double(), 2048, log_extra.double())
    scale = mvm.gram_mvm_plain(kind, *args, V.double().abs(), 2048, log_extra.double())
    err = (got.double() - ref).abs()
    return float((err / scale).max()), float(err.max())


def mvm_phase(torch, mvm):
    """K3 against its twin: five kinds, float32 and float64, n = 4096 and
    4097, k = 1, 9 and 256, each launched twice (bitwise equal); then timed
    at the path's shape (n = 100000, d = 8, float32; k = 9 in mBCG, k = 1 in
    LOVE, k = 17 in mBCG at the default 16 probes) beside the twin and the
    bound, and its float32 error there."""
    rows = []
    noise = 0.1 + IT_JITTER
    for dtype in (torch.float32, torch.float64):
        name = dtype_name(dtype)
        for n in (4096, 4097):
            for kind in KINDS:
                errs = []
                for k in (1, 9, 256):
                    xs, V, lv, le = radial_inputs(torch, n, k, dtype, seed=k)
                    got = mvm.gram_mvm(kind, xs, lv, noise, V, log_extra=le)
                    again = mvm.gram_mvm(kind, xs, lv, noise, V, log_extra=le)
                    torch.cuda.synchronize()
                    check(torch.equal(got, again), f"gram_mvm {kind} {name} n={n} k={k}: two launches differ")
                    rel, absolute = mvm_error(torch, mvm, got, kind, xs, lv, noise, V, le)
                    errs.append((k, rel, absolute))
                    check(rel <= MVM_TOL[name], f"gram_mvm {kind} {name} n={n} k={k}: {rel} > {MVM_TOL[name]}")
                print(f"# kernel gram_mvm {kind:8s} {name} n={n} d={D}: max |kernel-plain|/scale by k "
                      + ", ".join(f"k={k} {rel:.3e} (abs {a:.3e})" for k, rel, a in errs)
                      + f" (tol {MVM_TOL[name]:.0e}); two launches bitwise equal", flush=True)
                rows.append({"case": kind, "dtype": name, "n": n, "errors": errs, "tol": MVM_TOL[name]})
    torch.cuda.empty_cache()
    timed = {}
    for k in (9, 1, 17):
        xs, V, lv, le = radial_inputs(torch, IT_N, k, torch.float32, seed=100 + k)
        with torch.no_grad():
            got = mvm.gram_mvm("rbf", xs, lv, noise, V)
            rel, absolute = mvm_error(torch, mvm, got, "rbf", xs, lv, noise, V, le)
            ms = time_ms(lambda: mvm.gram_mvm("rbf", xs, lv, noise, V), 10)
            plain_ms = time_ms(lambda: mvm.gram_mvm_plain("rbf", xs, lv, noise, V, IT_SLAB), 1)
        bound, by = mvm_bound_ms(IT_N, D, k, "float32", 4)
        gbytes = (IT_N * D + 2 * IT_N * k) * 4 / 1e9
        print(f"# kernel gram_mvm rbf float32 n={IT_N} d={D} k={k}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
              f"bound {bound:.3f} ms ({by}), {100 * bound / ms:.1f} % of the bound, {gbytes / ms * 1e3:.2f} GB/s; "
              f"max |kernel-plain(f64)|/scale {rel:.3e} (tol {MVM_TOL['float32']:.0e}), max abs {absolute:.3e}",
              flush=True)
        check(rel <= MVM_TOL["float32"], f"gram_mvm rbf float32 n={IT_N} k={k}: {rel}")
        timed[k] = {"k": k, "n": IT_N, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                    "max_rel_err": rel, "max_abs_err": absolute, "gb_per_s": gbytes / ms * 1e3}
        del xs, V, got
        torch.cuda.empty_cache()
    return {"checks": rows, "timed": timed}


def lowrank_error(torch, lowrank, got, kind, xs, var, Wl, Wr, log_extra):
    """(max |kernel − twin| / scale over svar, grad_ell and sextra, max abs),
    the twin and the scales in float64."""
    args = (kind, xs.double(), var.double(), Wl.double(), Wr.double())
    ref = lowrank.lowrank_contractions_plain(*args, 2048, log_extra.double())
    scale = lowrank.lowrank_scales(*args, 256 if xs.shape[0] <= 8192 else 1024, log_extra.double())
    rel = absolute = 0.0
    for g, r, sc in zip(got, ref, scale):
        err = (g.double() - r).abs()
        absolute = max(absolute, float(err.max()))
        rel = max(rel, float((err / sc.clamp(min=1e-300)).max()))
    return rel, absolute


def lowrank_phase(torch, lowrank):
    """K4 against its twin: five kinds, float32 and float64, n = 4096 and
    4097, r = 9 and 17 (an asymmetric W = Wl·Wrᵀ), each launched twice
    (bitwise equal); then timed at the path's shape (n = 100000, d = 8,
    float32; r = 9 at 8 probes, r = 17 at the default 16) beside the twin
    and the bound, with its float32 error."""
    rows = []
    for dtype in (torch.float32, torch.float64):
        name = dtype_name(dtype)
        for n in (4096, 4097):
            tol = lowrank_tol(name, n)
            for kind in KINDS:
                errs = []
                for r in (9, 17):
                    xs, W, lv, le = radial_inputs(torch, n, 2 * r, dtype, seed=r)
                    Wl, Wr = W[:, :r].contiguous(), W[:, r:].contiguous()
                    var = torch.exp(lv)
                    got = lowrank.lowrank_contractions(kind, xs, var, Wl, Wr, log_extra=le)
                    again = lowrank.lowrank_contractions(kind, xs, var, Wl, Wr, log_extra=le)
                    torch.cuda.synchronize()
                    check(all(torch.equal(a, b) for a, b in zip(got, again)),
                          f"lowrank_contractions {kind} {name} n={n} r={r}: two launches differ")
                    rel, absolute = lowrank_error(torch, lowrank, got, kind, xs, var, Wl, Wr, le)
                    errs.append((r, rel, absolute))
                    check(rel <= tol, f"lowrank_contractions {kind} {name} n={n} r={r}: {rel} > {tol}")
                print(f"# kernel lowrank_contractions {kind:8s} {name} n={n} d={D}: max |kernel-plain|/scale by r "
                      + ", ".join(f"r={r} {rel:.3e} (abs {a:.3e})" for r, rel, a in errs)
                      + f" (tol {tol:.2e}); two launches bitwise equal", flush=True)
                rows.append({"case": kind, "dtype": name, "n": n, "errors": errs, "tol": tol})
    torch.cuda.empty_cache()
    timed = {}
    # r = 9: the backward at IT_PROBES = 8; r = 17: at GPR's default 16 probes (two launches, 16 + 1 columns)
    for r, seed in ((IT_PROBES + 1, 200), (17, 217)):
        xs, W, lv, le = radial_inputs(torch, IT_N, 2 * r, torch.float32, seed=seed)
        Wl, Wr, var = W[:, :r].contiguous(), W[:, r:].contiguous(), torch.exp(lv)
        with torch.no_grad():
            got = lowrank.lowrank_contractions("rbf", xs, var, Wl, Wr)
            rel, absolute = lowrank_error(torch, lowrank, got, "rbf", xs, var, Wl, Wr, le)
            ms = time_ms(lambda: lowrank.lowrank_contractions("rbf", xs, var, Wl, Wr), 5)
            plain_ms = time_ms(lambda: lowrank.lowrank_contractions_plain("rbf", xs, var, Wl, Wr, IT_SLAB), 1)
        bound, by = lowrank_bound_ms(IT_N, D, r, "float32", 4)
        ordered = lowrank_bound_ordered_ms(IT_N, D, r, "float32", 4)[0]
        gbytes = (IT_N * D + 2 * IT_N * r) * 4 / 1e9
        print(f"# kernel lowrank_contractions rbf float32 n={IT_N} d={D} r={r}: kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, bound {bound:.3f} ms ({by}, unordered pairs), {100 * bound / ms:.1f} % of the "
              f"bound (over ordered pairs, as first stated: {ordered:.3f} ms, {100 * ordered / ms:.1f} %), "
              f"{gbytes / ms * 1e3:.2f} GB/s; max |kernel-plain(f64)|/scale {rel:.3e} "
              f"(tol {lowrank_tol('float32', IT_N):.2e}), max abs {absolute:.3e}", flush=True)
        check(rel <= lowrank_tol("float32", IT_N), f"lowrank_contractions rbf float32 n={IT_N} r={r}: {rel}")
        timed[r] = {"r": r, "n": IT_N, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                    "ordered_bound_ms": ordered, "max_rel_err": rel, "max_abs_err": absolute,
                    "gb_per_s": gbytes / ms * 1e3}
        del xs, W, Wl, Wr
        torch.cuda.empty_cache()
    return {"checks": rows, "timed": timed}


def iterative_model(n, dtype, device=None, precond_rank=IT_RANK, cg_tol=IT_TOL, max_cg_iters=IT_CG_ITERS):
    """bench_iterative.py's model on make_data's data (bench.py's: x ~ N(0,
    I), y = sin(x₀) + 0.1ε, RandomState(0)) and its query batches."""
    from gptorch_tpu_torch import kernels, likelihoods
    from gptorch_tpu_torch.models import GPR

    x, y, xq = make_data(n, D, dtype)
    model = GPR(x, y, kernels.Rbf(D, ARD=True), likelihood=likelihoods.Gaussian(0.1), solver="iterative",
                probes=IT_PROBES, max_cg_iters=max_cg_iters, precond_rank=precond_rank, cg_tol=cg_tol,
                mvm_slab=IT_SLAB, fast_jitter=IT_JITTER, device=device)
    return model, xq


def iterative_value_and_grad(torch, model):
    """One loss and backward of any model (the matrix-free GPR's, the
    Vecchia GP's, ...); returns (loss, the gradient as one float64 vector
    in sorted trainable order; zeros for a trainable the loss does not
    read, as GridGPR's duplicate ``kernel.*``)."""
    from gptorch_tpu_torch.module import get_trainable

    model.zero_grad(set_to_none=True)
    loss = model.loss()
    loss.backward()
    raws = get_trainable(model)
    grads = [torch.zeros_like(raws[k]) if raws[k].grad is None else raws[k].grad for k in sorted(raws)]
    return float(loss.detach()), np.concatenate([g.double().cpu().numpy().ravel() for g in grads])


def iterative_training_phase(torch):
    """The matrix-free exact GP at n = 100000 (see IT_N): one warm
    value-and-grad, two timed ones (CUDA events), fit_scan Adam (eager by
    fit.captures' rule), the stages of one value-and-grad, the diagnostics,
    and float32 against float64 at full n from the same seeds."""
    from gptorch_tpu_torch.training import fit

    model, xq = iterative_model(IT_N, np.float32)
    check(model.device.type == "cuda" and model._iterative_eligible(model.X), "the iterative model is not on the card")
    check(not fit.captures(model, "Adam"), "fit_scan would capture the iterative step")
    out = {"n": IT_N, "d": D, "dtype": "float32", "probes": IT_PROBES, "max_cg_iters": IT_CG_ITERS,
           "precond_rank": IT_RANK, "cg_tol": IT_TOL}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # the model, and what earlier phases still hold
    t0 = time.perf_counter()
    iterative_value_and_grad(torch, model)
    torch.cuda.synchronize()
    out["warm_s"] = time.perf_counter() - t0
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["step_mem_gb"] = (torch.cuda.max_memory_allocated() - held) / 1e9

    zero_counts()
    times, values = [], []
    for _ in range(2):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        values.append(iterative_value_and_grad(torch, model)[0])
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    t0 = time.perf_counter()
    losses = model.fit_scan("Adam", max_iter=IT_STEPS, learning_rate=TRAIN_LR)
    torch.cuda.synchronize()
    out["fit_scan_s_per_step"] = (time.perf_counter() - t0) / IT_STEPS
    out["launches"] = read_counts()
    out["s_per_step"] = times
    out["steps_per_s"] = [1.0 / t for t in times]
    out["losses"] = values + [float(v) for v in losses.cpu()]
    print(f"# iterative training n={IT_N} d={D} f32 probes={IT_PROBES} cg={IT_CG_ITERS} rank={IT_RANK} "
          f"tol={IT_TOL}: warm value-and-grad {out['warm_s']:.3f} s; timed {', '.join(f'{t:.4f}' for t in times)} "
          f"s/step ({', '.join(f'{v:.4f}' for v in out['steps_per_s'])} steps/s); fit_scan Adam lr {TRAIN_LR} "
          f"(eager) {out['fit_scan_s_per_step']:.4f} s/step; losses {out['losses']}; peak device memory "
          f"{out['peak_mem_gb']:.3f} GB, of which the value-and-grad's own {out['step_mem_gb']:.3f} GB; launches "
          f"{out['launches']}", flush=True)
    check(all(math.isfinite(v) for v in out["losses"]), "non-finite iterative loss")
    check(not fit.fit_scan.last_run["captured"], "fit_scan captured the iterative step")
    for name in ("gram_mvm", "lowrank_contractions"):
        check(out["launches"][name] > 0, f"the iterative training path never launched {name}")

    t0 = time.perf_counter()
    diag = model.iterative_diagnostics()
    out["diagnostics_s"] = time.perf_counter() - t0
    out["diagnostics"] = {"nlml_stderr": float(diag["nlml_stderr"]), "logdet_stderr": float(diag["logdet_stderr"]),
                          "cg_iters": diag["cg_iters"].tolist(), "cg_relres": diag["cg_relres"].tolist()}
    print(f"# iterative diagnostics n={IT_N} ({out['diagnostics_s']:.3f} s): nlml_stderr "
          f"{out['diagnostics']['nlml_stderr']:.4f}, CG iterations {out['diagnostics']['cg_iters']}, relative "
          f"residuals {[f'{v:.2e}' for v in out['diagnostics']['cg_relres']]}", flush=True)
    check(np.isfinite(diag["cg_relres"]).all(), "non-finite CG residuals")
    out["stages_ms"] = iterative_stages(torch, model)
    out["f32_vs_f64"] = iterative_f32_vs_f64(torch, model)
    return model, xq, out


def iterative_stages(torch, model):
    """Warm CUDA-event times of the stages of one value-and-grad at the
    model's values, each through the function the path calls: the pivoted
    Cholesky; the forward's solve (iterative._solve_system: the pivoted
    Cholesky, the probes and mBCG), with its K3 share (IT_CG_ITERS products
    with k = dy + probes); the SLQ's batched eigh; and K4 on the backward's
    factors (iterative._adjoint_factors)."""
    from gptorch_tpu_torch.ops import gpr_fast, iterative, lowrank_contract, mvm

    vg_ms = time_ms(lambda: iterative_value_and_grad(torch, model), 1)
    model.zero_grad(set_to_none=True)
    with torch.no_grad():
        kind, le, lv, ln, extra = model._iterative_args()
        dy = model.Y.shape[1]
        args = (kind, le, lv, ln, model.X, model.Y, model.probe_seeds, model.fast_jitter, model.mvm_slab,
                model.max_cg_iters, model.precond_rank, model.cg_tol, extra)
        Lpc, noise, precond, Z, B, Xs, alphas, betas, valid = iterative._solve_system(*args)
        V = precond(Z)
        Wl, Wr = iterative._adjoint_factors(Xs[:, :dy], Xs[:, dy:], V)
        sq = torch.sum(Z * V, dim=0)
        xs = gpr_fast._scaled(model.X, le).contiguous()
        n, k, t, m = B.shape[0], B.shape[1], Z.shape[1], model.max_cg_iters
        k3_bound = (m * mvm_bound_ms(n, D, k, "float32", 4)[0], "operations")
        stages = {
            f"pivoted_cholesky (rank {model.precond_rank})": (
                lambda: iterative.pivoted_cholesky(kind, le, lv, model.X, model.precond_rank, extra), 2, None),
            f"forward solve: pivoted Cholesky + mbcg ({m} steps, k={k})": (
                lambda: iterative._solve_system(*args), 1, (k3_bound[0], "K3's operations")),
            f"  of which K3 gram_mvm x {m} (k={k})": (
                lambda: [mvm.gram_mvm(kind, xs, lv, noise, B) for _ in range(m)], 1, k3_bound),
            f"SLQ: batched eigh of ({t}, {m}, {m})": (
                lambda: iterative._slq_probe_values(alphas[:, dy:], betas[:, dy:], valid[:, dy:], sq), 3, None),
            f"backward: K4 lowrank_contractions (r={Wl.shape[1]}; bound over ordered pairs, as first stated, "
            f"{lowrank_bound_ordered_ms(n, D, Wl.shape[1], 'float32', 4)[0]:.3f} ms)": (
                lambda: lowrank_contract.lowrank_contractions(kind, xs, torch.exp(lv), Wl, Wr), 3,
                lowrank_bound_ms(n, D, Wl.shape[1], "float32", 4)),
        }
        times = {"value_and_grad (loss + backward)": (vg_ms, None)}
        times.update({name: (time_ms(fn, reps), bound) for name, (fn, reps, bound) in stages.items()})
    for name, (ms, bound) in times.items():
        extra_txt = f" (bound {bound[0]:.3f} ms, {bound[1]})" if bound else ""
        print(f"# iterative stage {name}: {ms:.3f} ms{extra_txt}", flush=True)
    del Lpc, Z, B, Xs, V, Wl, Wr
    torch.cuda.empty_cache()
    return {name: ms for name, (ms, _) in times.items()}


def iterative_f32_vs_f64(torch, model):
    """The NLML and gradient at full n in float32 against float64 on the
    card, at the trained model's values and from the same probe seeds (the
    float32 ones, widened), with a rank-1 preconditioner.  At the path's
    rank 64 the two types choose different pivots: after the first pivot
    most residual diagonals are σ² − O(1e-7), which float32 rounds to ties
    that its argmax breaks by index and float64 does not, so the two
    preconditioners, and with them the probes z ~ N(0, P) and the SLQ and
    Hutchinson estimates, differ by the estimator's Monte-Carlo noise.
    The first pivot is row 0 in both (every diagonal is σ² exactly), so at
    rank 1 they share P, and what is left is arithmetic: each type stops
    CG at relative residual 1e-4 on a step of its own, so the solves, and
    the data term and traces linear in them, agree to about that
    tolerance: the NLML to 1e-4 relative, the gradient to 1e-3 of its
    largest entry."""
    from gptorch_tpu_torch import convert
    from gptorch_tpu_torch.module import get_trainable

    values = {k: v.detach().double().cpu().numpy() for k, v in get_trainable(model).items()}
    m32, _ = iterative_model(IT_N, np.float32, precond_rank=1)
    convert.load_trainable(m32, values)
    v32, g32 = iterative_value_and_grad(torch, m32)
    with default_dtype(torch, torch.float64):
        m64, _ = iterative_model(IT_N, np.float32, precond_rank=1)
        m64 = m64.double()
        convert.load_trainable(m64, values)
        m64.probe_seeds = m32.probe_seeds.double()
        v64, g64 = iterative_value_and_grad(torch, m64)
    del m32, m64
    torch.cuda.empty_cache()
    value_rel = abs(v32 - v64) / abs(v64)
    grad_rel = float(np.abs(g32 - g64).max() / np.abs(g64).max())
    print(f"# iterative f32 vs f64 at n={IT_N} (preconditioner rank 1): NLML {v32!r} vs {v64!r} (rel "
          f"{value_rel:.3e}, tol 1e-4); gradient max|g32-g64|/max|g64| = {grad_rel:.3e} (tol 1e-3); g32 "
          f"{g32.tolist()}, g64 {g64.tolist()}", flush=True)
    check(value_rel <= 1e-4, f"iterative f32 vs f64 NLML: {value_rel}")
    check(grad_rel <= 1e-3, f"iterative f32 vs f64 gradient: {grad_rel}")
    return {"nlml_f32": v32, "nlml_f64": v64, "value_rel": value_rel, "grad_rel": grad_rel}


def iterative_serving_phase(torch, model, xq):
    """posterior(love_rank=256) of the trained n = 100000 model, then 8
    batches of 256 queries through predict_f (CUDA events); then one
    CG-exact predict_f of 16 queries on a posterior without LOVE, against
    the LOVE posterior's moments at the same queries."""
    out = {"n": IT_N, "love_rank": IT_LOVE_RANK, "q": Q, "batches": BATCHES}
    xq = [torch.as_tensor(b, device="cuda") for b in xq]
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    post = model.posterior(love_rank=IT_LOVE_RANK)
    torch.cuda.synchronize()
    out["love_build_s"] = time.perf_counter() - t0
    ms, moments = [], []
    with torch.no_grad():
        for b in xq:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            moments.append(post.predict_f(b))
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
    out["launches"] = read_counts()
    out["predict_ms"] = ms
    mu, var = moments[0]
    check(all(torch.isfinite(m).all() and torch.isfinite(v).all() and m.shape == (Q, 1) for m, v in moments),
          "bad LOVE predict_f output")
    check(out["launches"]["gram_mvm"] > 0 and out["launches"]["rbf_gram"] > 0,
          f"the iterative serving path did not launch gram_mvm and rbf_gram: {out['launches']}")
    t0 = time.perf_counter()
    exact = model.posterior()
    torch.cuda.synchronize()
    out["cg_posterior_s"] = time.perf_counter() - t0
    with torch.no_grad():
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        mu_cg, var_cg = exact.predict_f(xq[0][:IT_CG_QUERIES])
        end.record()
        end.synchronize()
    out["cg_predict_ms"] = start.elapsed_time(end)
    q = IT_CG_QUERIES
    # both means are K(x*, X)·α with the same α (the same CG on the same
    # inputs through deterministic kernels), but cuBLAS sums the n products
    # in another order for 16 columns than for 256: they agree to float32
    # roundoff, held to u·Σ|k||α| (u = 2⁻²⁴).  A blocked sum's worst case is
    # a multiple of that (log₂ n for a pairwise one); rounding errors that
    # behave as random, as these do, stay well below it.
    mean_scale = float((exact.kernel.K(exact.X, xq[0][:q]).abs().T @ exact.alpha.abs()).max())
    out["mean_gap"] = float((mu[:q] - mu_cg).abs().max())
    out["var_gap"] = float((var[:q] - var_cg).abs().max())
    out["var_rel_gap"] = float(((var[:q] - var_cg).abs() / var_cg.abs()).max())
    out["mean_tol"] = F32_UNIT_ROUNDOFF * mean_scale
    print(f"# iterative serving n={IT_N} LOVE rank {IT_LOVE_RANK}: posterior() {out['love_build_s']:.3f} s; "
          f"predict_f per batch of {Q} (ms) {[round(v, 3) for v in ms]}, median {float(np.median(ms)):.3f}; "
          f"launches {out['launches']}; CG-exact posterior() {out['cg_posterior_s']:.3f} s, predict_f of {q} "
          f"{out['cg_predict_ms']:.1f} ms; LOVE vs CG-exact: means max gap {out['mean_gap']:.3e}, variances "
          f"max gap {out['var_gap']:.3e} (rel {out['var_rel_gap']:.3e}; CG-exact variances "
          f"{float(var_cg.min()):.4e}..{float(var_cg.max()):.4e}, LOVE variances "
          f"{float(var[:q].min()):.4e}..{float(var[:q].max()):.4e}); means held to u*sum|k||alpha| = "
          f"{out['mean_tol']:.3e}", flush=True)
    check(out["mean_gap"] <= out["mean_tol"], f"LOVE and CG-exact means differ: {out['mean_gap']} > {out['mean_tol']}")
    del post, exact
    torch.cuda.empty_cache()
    return out


def iterative_check_run(torch, device):
    """One route of iterative_card_vs_cpu at n = 4096 in float64, CG to
    IT_CHECK_TOL: the loss and gradient, α and the LOVE variances of the
    posterior, the diagnostics, and the kernel launches (as numpy values)."""
    model, xq = iterative_model(IT_CHECK_N, np.float64, device=device, cg_tol=IT_CHECK_TOL,
                                max_cg_iters=IT_CHECK_ITERS)
    zero_counts()
    value, grad = iterative_value_and_grad(torch, model)
    post = model.posterior(love_rank=IT_CHECK_LOVE)
    _, var = post.predict_f(xq[0])
    out = {"value": value, "grad": grad, "alpha": post.alpha.detach().cpu().numpy(), "var": var,
           **{"diag_" + k: v for k, v in model.iterative_diagnostics().items()}}
    return out, read_counts()


def iterative_cpu_reference(path):
    """The CPU side of iterative_card_vs_cpu, written to ``path`` (npz).
    Run by a background process of this script
    (``--iterative-cpu-reference PATH``) from the start of the zoo phases,
    on half the cores: the card's phases keep the rest for their host
    threads and the zoo check's reference."""
    import torch

    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    with default_dtype(torch, torch.float64):
        out, launches = iterative_check_run(torch, "cpu")
    np.savez(path, launched=sum(launches.values()), **out)
    return 0


def stop_process(proc):
    """Kill ``proc`` if it is still running, and reap it."""
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def iterative_card_vs_cpu(torch, reference):
    """n = 4096 in float64: GPR(solver="iterative") on the card (K3, K4)
    against the CPU's plain route from the same seeds, which ``reference``
    (``--iterative-cpu-reference``) computes in the background: the
    loss, the gradient, α, the LOVE posterior's variances and the
    diagnostics' logdet and stderr, each to 1e-8 relative.  CG's per-step
    coefficients are chaotic in floating point (tests/test_torch_iterative.py),
    so the two routes stop their columns on steps of their own; solved to
    1e-10 (IT_CHECK_TOL), what follows from the solves agrees all the same."""
    proc, path, log = reference
    try:
        with default_dtype(torch, torch.float64):
            card, launches = iterative_check_run(torch, "cuda")
        t0 = time.perf_counter()
        code = proc.wait(timeout=900)
        waited = time.perf_counter() - t0
        if code != 0:
            with open(log) as f:
                print(f.read(), file=sys.stderr)
        check(code == 0, f"the iterative CPU reference process failed (exit {code})")
        cpu = dict(np.load(path))
    finally:
        stop_process(proc)
    check(launches["gram_mvm"] > 0 and launches["lowrank_contractions"] > 0, f"the card route launched {launches}")
    check(int(cpu["launched"]) == 0, "the CPU launched")

    def rel(key):
        return float(np.abs(card[key] - cpu[key]).max() / np.abs(cpu[key]).max())

    rels = {what: rel(key) for what, key in (("loss", "value"), ("gradient", "grad"), ("alpha", "alpha"),
                                             ("LOVE variances", "var"), ("logdet estimate", "diag_logdet_estimate"),
                                             ("nlml_stderr", "diag_nlml_stderr"))}
    iters = (card["diag_cg_iters"].tolist(), cpu["diag_cg_iters"].tolist())
    print(f"# iterative f64 card vs CPU n={IT_CHECK_N} (CG to {IT_CHECK_TOL:.0e} in up to {IT_CHECK_ITERS} steps, "
          f"LOVE rank {IT_CHECK_LOVE}): max relative gaps " + ", ".join(f"{k} {v:.3e}" for k, v in rels.items())
          + f" (tol {F64_REL_TOL}); CG iterations card {iters[0]}, CPU {iters[1]}; relative residuals card max "
          f"{float(card['diag_cg_relres'].max()):.2e}, CPU max {float(cpu['diag_cg_relres'].max()):.2e}; card "
          f"launches {launches}; waited {waited:.1f} s for the CPU", flush=True)
    for what, value in rels.items():
        check(value <= F64_REL_TOL, f"iterative card vs CPU {what}: {value} > {F64_REL_TOL}")
    return {**{k.replace(" ", "_") + "_rel": v for k, v in rels.items()}, "cg_iters": iters, "launches": launches,
            "cpu_wait_s": waited}


# ---------------------------------------------------------------------------
# ψ-statistics, the Bayesian GPLVM, uncertain-input prediction and the
# Vecchia GP.


def psi_inputs(torch, n, m, q, dtype, seed=0):
    """bench_ekernels.py's inputs: Z (m, q), Xmean (n, q) ~ N(0, 1) and
    diagonal Xcov = 0.1 + 0.05·U(0, 1), from one RandomState, on the card."""
    rng = np.random.RandomState(seed)
    arrays = (rng.randn(m, q), rng.randn(n, q), 0.1 + 0.05 * rng.rand(n, q))
    return tuple(torch.as_tensor(a, dtype=dtype, device="cuda") for a in arrays)


def psi_ops(n, m, q):
    """Operations of ψ₀ + Σψ₁ + Σψ₂ as the code forms them: per (i, k) of
    ψ₁ a difference, a square, a division and an add per dimension, the
    exp and the variance (4q + 2); per (i, k, l) of ψ₂ the Gram's q
    multiply-adds (2q), the exponent's nine adds and scales, the exp, σ⁴
    and the sum over data (2q + 12)."""
    return n * m * (4 * q + 2) + n * m * m * (2 * q + 12)


def psi_statistics_phase(torch):
    """The ψ-statistics at bench_ekernels.py's cell (n = 1000, m = 50,
    q = 10, float32, Rbf-ARD): ψ₀ + Σψ₁ + Σψ₂ and its value-and-grad with
    respect to the kernel's hyperparameters and Xmean (warm CUDA events),
    each against its operation bound; float32 against float64 on the card;
    then ψ₂ per datum (``sum=False``) at the sparse width (n* = 256,
    m = 1024, q = 9), whose (n*, m, m) output bounds it by bytes."""
    from gptorch_tpu_torch import ekernels

    out = {"n": EK_N, "m": EK_M, "q": EK_Q, "dtype": "float32"}
    kern = ekernels.Rbf(EK_Q, ARD=True).to("cuda")
    Z, Xmean, Xcov = psi_inputs(torch, EK_N, EK_M, EK_Q, torch.float32)
    xm = Xmean.clone().requires_grad_(True)

    def psi_all(k, Z, Xmean, Xcov):
        return (torch.sum(k.eKxx(Xmean)) + torch.sum(k.eKxz(Z, Xmean, Xcov))
                + torch.sum(k.eKzxKxz(Z, Xmean, Xcov, sum=True)))

    def value_and_grad():
        kern.zero_grad(set_to_none=True)
        xm.grad = None
        psi_all(kern, Z, xm, Xcov).backward()

    zero_counts()
    with gram_launch_shapes() as shapes:
        with torch.no_grad():
            out["forward_ms"] = time_ms(lambda: psi_all(kern, Z, Xmean, Xcov), 20)
        out["value_and_grad_ms"] = time_ms(value_and_grad, 20)
    out["launches"] = read_counts()
    out["rbf_gram_shapes"] = shapes
    ops = psi_ops(EK_N, EK_M, EK_Q)
    in_bytes = (EK_M * EK_Q + 2 * EK_N * EK_Q + 2 * EK_Q + 1) * 4
    out["forward_bound_ms"], out["forward_bound_by"] = bound_ms(in_bytes + 4, ops, "float32")
    # the backward of each elementwise map and product costs about twice its forward
    out["value_and_grad_bound_ms"], _ = bound_ms(2 * in_bytes, 3 * ops, "float32")

    # float32 against float64 on the same inputs, each statistic by its largest entry
    k64 = ekernels.Rbf(EK_Q, ARD=True).to("cuda").double()
    Z64, X64, C64 = (a.double() for a in (Z, Xmean, Xcov))
    with torch.no_grad():
        pairs = {"psi0": (kern.eKxx(Xmean), k64.eKxx(X64)),
                 "psi1": (kern.eKxz(Z, Xmean, Xcov), k64.eKxz(Z64, X64, C64)),
                 "psi2": (kern.eKzxKxz(Z, Xmean, Xcov), k64.eKzxKxz(Z64, X64, C64))}
    out["f32_vs_f64"] = {k: float((a.double() - b).abs().max() / b.abs().max()) for k, (a, b) in pairs.items()}
    # the limit's control: ψ₂'s products (its Gram of scaled inducing inputs) in TF32
    with torch.no_grad(), tf32_allowed(torch):
        psi2_tf32 = kern.eKzxKxz(Z, Xmean, Xcov)
    want = pairs["psi2"][1]
    out["psi2_tf32_control"] = float((psi2_tf32.double() - want).abs().max() / want.abs().max())

    # ψ₂ per datum at the sparse width: n* queries against the sparse cell's inducing inputs
    _, _, z = sparse_data(SP_N, SP_D, SP_M, np.float32)
    kern9 = ekernels.Rbf(SP_D, ARD=True).to("cuda")
    rng = np.random.RandomState(1)
    zq = torch.as_tensor(z, device="cuda")
    xq = torch.as_tensor(rng.randn(EK_QUERIES, SP_D), dtype=torch.float32, device="cuda")
    xv = torch.as_tensor(0.1 + 0.05 * rng.rand(EK_QUERIES, SP_D), dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        out["psi2_each_ms"] = time_ms(lambda: kern9.eKzxKxz(zq, xq, xv, sum=False), 3)
        each = kern9.eKzxKxz(zq, xq, xv, sum=False)
        check(tuple(each.shape) == (EK_QUERIES, SP_M, SP_M) and bool(torch.isfinite(each).all()),
              "psi2 per datum: wrong shape or non-finite")
    out["psi2_each_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del each
    torch.cuda.empty_cache()
    each_bytes = (EK_QUERIES * SP_M * SP_M + SP_M * SP_D + 2 * EK_QUERIES * SP_D) * 4
    out["psi2_each_bound_ms"], out["psi2_each_bound_by"] = bound_ms(
        each_bytes, EK_QUERIES * SP_M * SP_M * (2 * SP_D + 11), "float32")
    print(f"# psi statistics rbf-ARD n={EK_N} m={EK_M} q={EK_Q} f32: psi0 + sum psi1 + sum psi2 "
          f"{out['forward_ms']:.4f} ms (bound {out['forward_bound_ms']:.5f} ms, {out['forward_bound_by']}), "
          f"value-and-grad (hyperparameters, Xmean) {out['value_and_grad_ms']:.4f} ms (bound "
          f"{out['value_and_grad_bound_ms']:.5f} ms, operations); f32 vs f64 max relative "
          + ", ".join(f"{k} {v:.3e}" for k, v in out["f32_vs_f64"].items()) + f" (tol {PSI_F32_TOL}; control: "
          f"psi2 with TF32 products {out['psi2_tf32_control']:.3e}, must exceed it); launches "
          f"{out['launches']}", flush=True)
    print(f"# psi2 per datum (sum=False) n*={EK_QUERIES} m={SP_M} q={SP_D} f32: {out['psi2_each_ms']:.3f} ms "
          f"(bound {out['psi2_each_bound_ms']:.3f} ms, {out['psi2_each_bound_by']}: the (n*, m, m) output), peak "
          f"{out['psi2_each_peak_gb']:.2f} GB", flush=True)
    for key, value in out["f32_vs_f64"].items():
        check(value <= PSI_F32_TOL, f"psi statistics f32 vs f64 {key}: {value} > {PSI_F32_TOL}")
    check(out["psi2_tf32_control"] > PSI_F32_TOL,
          f"the psi limit {PSI_F32_TOL} passes psi2 with TF32 products ({out['psi2_tf32_control']})")
    return out


def gplvm_data(n, p, dtype, seed=0):
    """Synthetic data of the oil-flow set's shape: a 2-D latent curve
    lifted by tanh of a random map into p outputs plus 0.1 noise."""
    rng = np.random.RandomState(seed)
    t = rng.randn(n, 2)
    return (np.tanh(t @ rng.randn(2, p)) + 0.1 * rng.randn(n, p)).astype(dtype)


def gplvm_phase(torch):
    """The Bayesian GPLVM at the oil-flow data's shape (n = 1000, p = 12,
    q = 10, m = 50, float32, synthetic Y from a seed) under the fixed jitter
    policy: fit_scan Adam (a warm and a timed call, captured), then
    posterior(), predict_f at the latents, predict_uncertain over 256 of
    them, project of 16 new rows and impute of 16 rows with half their
    outputs observed.  Then the float64 card-against-CPU check."""
    from gptorch_tpu_torch import settings
    from gptorch_tpu_torch.models import GPLVM

    y = gplvm_data(GP_N, GP_P, np.float32)
    y_new = gplvm_data(GP_PROJECT_ROWS, GP_P, np.float32, seed=1)
    observed = np.arange(GP_P // 2)
    out = {"n": GP_N, "p": GP_P, "q": GP_Q, "m": GP_M, "dtype": "float32", "steps": GP_STEPS, "lr": GP_LR}
    with settings.override(jitter_policy="fixed"), gram_launch_shapes() as shapes:
        t0 = time.perf_counter()
        model = GPLVM(y, GP_Q, num_inducing_points=GP_M)
        torch.cuda.synchronize()
        out["build_s"] = time.perf_counter() - t0
        check(model.device.type == "cuda", "GPLVM did not land on the card")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        warm = model.fit_scan("Adam", max_iter=GP_STEPS, learning_rate=GP_LR)
        torch.cuda.synchronize()
        out["warm_call_s"] = time.perf_counter() - t0
        out["launches_per_captured_step"] = check_captured("gplvm training")
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9

        zero_counts()
        t0 = time.perf_counter()
        losses = model.fit_scan("Adam", max_iter=GP_STEPS, learning_rate=GP_LR)
        torch.cuda.synchronize()
        out["step_ms"] = 1e3 * (time.perf_counter() - t0) / GP_STEPS
        replayed = replayed_launches()
        out["losses"] = [float(v) for v in torch.cat([warm, losses]).cpu()]

        def timed(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = fn()
            torch.cuda.synchronize()
            return result, 1e3 * (time.perf_counter() - t0)

        post, out["posterior_ms"] = timed(model.posterior)
        latents = model.Xmean.value.detach().cpu().numpy()
        latent_var = model.Xvar.value.detach().cpu().numpy()
        (mu_f, var_f), out["predict_f_ms"] = timed(lambda: model.predict_f(latents))
        (mu_u, var_u), out["predict_uncertain_ms"] = timed(
            lambda: model.predict_uncertain(latents[:Q], latent_var[:Q]))
        (x_mean, x_var), out["project_ms"] = timed(
            lambda: model.project(y_new, max_iter=GP_PROJECT_ITERS))
        (imp_mu, imp_var), out["impute_ms"] = timed(
            lambda: model.impute(y_new[:, observed], observed, max_iter=GP_PROJECT_ITERS))
        post_mu, _ = post.predict_f(latents[:Q])
        out["launches"] = add_counts(read_counts(), replayed)
    out["rbf_gram_shapes"] = shapes
    print(f"# gplvm n={GP_N} p={GP_P} q={GP_Q} m={GP_M} f32 fit_scan Adam lr={GP_LR} (captured, launches recorded "
          f"per captured step {out['launches_per_captured_step']}): build {out['build_s']:.3f} s, warm call of "
          f"{GP_STEPS} steps {out['warm_call_s']:.3f} s, timed {out['step_ms']:.4f} ms/step; posterior "
          f"{out['posterior_ms']:.3f} ms, predict_f at {GP_N} latents {out['predict_f_ms']:.3f} ms, predict_uncertain "
          f"of {Q} {out['predict_uncertain_ms']:.3f} ms, project of {GP_PROJECT_ROWS} rows ({GP_PROJECT_ITERS} Adam "
          f"steps, eager) {out['project_ms']:.1f} ms, impute {out['impute_ms']:.1f} ms; launches {out['launches']}; "
          f"peak {out['peak_mem_gb']:.3f} GB; bound (-loss) {-out['losses'][0]:.3f} -> {-out['losses'][-1]:.3f}",
          flush=True)
    check(all(math.isfinite(v) for v in out["losses"]), "non-finite GPLVM loss")
    check(out["losses"][-1] < out["losses"][0], "the GPLVM bound did not rise")
    check(out["launches"]["rbf_gram"] > 0, "the GPLVM path never launched rbf_gram")
    for name, a, shape in (("predict_f mean", mu_f, (GP_N, GP_P)), ("predict_f var", var_f, (GP_N, GP_P)),
                           ("predict_uncertain mean", mu_u, (Q, GP_P)), ("predict_uncertain var", var_u, (Q, GP_P)),
                           ("project mean", x_mean, (GP_PROJECT_ROWS, GP_Q)),
                           ("project var", x_var, (GP_PROJECT_ROWS, GP_Q)),
                           ("impute mean", imp_mu, (GP_PROJECT_ROWS, GP_P)),
                           ("impute var", imp_var, (GP_PROJECT_ROWS, GP_P))):
        check(a.shape == shape and np.isfinite(a).all(), f"GPLVM {name}: shape {a.shape} or non-finite")
    check((x_var > 0).all() and (var_u > 0).all(), "GPLVM: non-positive variances")
    # the cached posterior at the latents is the model's own predict_f
    gap = float(np.abs(post_mu - mu_f[:Q]).max())
    check(gap <= 1e-4 * max(1.0, float(np.abs(mu_f).max())), f"GPLVM posterior vs predict_f: {gap}")
    out["card_vs_cpu"] = gplvm_card_vs_cpu(torch)
    return out


def gplvm_check_run(torch, name, device):
    """One route of gplvm_card_vs_cpu: the loss and gradient of one
    configuration at GP_CHECK's shape, and its predict_uncertain with
    diagonal and full input covariances (numpy values)."""
    from gptorch_tpu_torch import ekernels, kernels
    from gptorch_tpu_torch.models import GPLVM
    from gptorch_tpu_torch.module import get_trainable

    n, p, q, m = GP_CHECK
    dynamical = dict(times=np.arange(n, dtype=float), time_kernel=kernels.Rbf(1, length_scales=3.0))
    kw = {"iid": {}, "dynamical": dynamical, "reparam": dict(dynamical, reparam=True), "large_p": {"large_p": True},
          "linear": {"kernel": ekernels.Linear(q, variance=np.array([0.8, 1.3, 0.6]))}}[name]
    model = GPLVM(gplvm_data(n, p, np.float64, seed=2), q, num_inducing_points=m, device=device, **kw)
    loss = model._loss()
    loss.backward()
    raws = get_trainable(model)
    rng = np.random.RandomState(3)
    xq, xv, a = rng.randn(5, q), 0.2 * np.exp(rng.randn(5, q)), 0.3 * rng.randn(5, q, q)
    xs = a @ a.transpose(0, 2, 1) + 0.05 * np.eye(q)
    return {"loss": np.array([float(loss.detach())]),
            "grad": np.concatenate([raws[k].grad.cpu().numpy().ravel() for k in sorted(raws)]),
            **{f"u_{c}_{i}": v for c, cov in (("diag", xv), ("full", xs))
               for i, v in enumerate(model.predict_uncertain(xq, cov))}}


def gplvm_card_vs_cpu(torch):
    """Float64, a small shape (GP_CHECK): the GPLVM's loss, gradient and
    predict_uncertain (diagonal and full input covariances) on the card
    against the CPU for the iid, dynamical and reparameterized priors, the
    large-p form and the Linear ψ-kernel, each to F64_REL_TOL relative
    (gradients relative to their largest entry)."""
    from gptorch_tpu_torch import settings

    worst = {}
    with default_dtype(torch, torch.float64), settings.override(jitter_policy="fixed"):
        for name in ("iid", "dynamical", "reparam", "large_p", "linear"):
            zero_counts()
            card = gplvm_check_run(torch, name, "cuda")
            launched = read_counts()["rbf_gram"]
            cpu = gplvm_check_run(torch, name, "cpu")
            rel = max(float(np.abs(card[k] - cpu[k]).max() / max(np.abs(cpu[k]).max(), 1e-300)) for k in cpu)
            worst[name] = rel
            check(name == "linear" or launched > 0, f"gplvm {name}: the card route never launched rbf_gram")
    print(f"# gplvm f64 card vs CPU (n, p, q, m) = {GP_CHECK}: max relative gap over loss, gradient and "
          f"predict_uncertain (diagonal and full covariances) " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
          + f" (tol {F64_REL_TOL})", flush=True)
    for name, rel in worst.items():
        check(rel <= F64_REL_TOL, f"gplvm card vs CPU {name}: {rel} > {F64_REL_TOL}")
    return worst


def uncertain_models(torch, dtype, names=("vfe", "svgp", "gpr"), device=None):
    """VFE and SVGP at bench_svgp.py's data (n = 45730, d = 9, m = 1024) and
    GPR at n = 4096, d = 8, each with ekernels.Rbf(ARD), under the caller's
    jitter policy, with their queries: {name: (model, x_mean, x_var)} for
    ``names``, on ``device`` (the card by default)."""
    from gptorch_tpu_torch import ekernels, likelihoods
    from gptorch_tpu_torch.models import GPR, SVGP, VFE

    x, y, z = sparse_data(SP_N, SP_D, SP_M, dtype)
    gx, gy, _ = make_data(UP_GPR_N, D, dtype)
    rng = np.random.RandomState(5)
    xq, xv = rng.randn(Q, SP_D).astype(dtype), (0.01 + 0.04 * rng.rand(Q, SP_D)).astype(dtype)
    gq, gv = rng.randn(UP_GPR_QUERIES, D).astype(dtype), (0.01 + 0.04 * rng.rand(UP_GPR_QUERIES, D)).astype(dtype)
    make = {
        "vfe": lambda: (VFE(x, y, ekernels.Rbf(SP_D, ARD=True), inducing_points=z, jitter=SP_JITTER,
                            device=device), xq, xv),
        "svgp": lambda: (SVGP(x, y, ekernels.Rbf(SP_D, ARD=True), inducing_points=z, jitter=SP_JITTER,
                              device=device), xq, xv),
        "gpr": lambda: (GPR(gx, gy, ekernels.Rbf(D, ARD=True), likelihood=likelihoods.Gaussian(0.1), device=device),
                        gq, gv),
    }
    return {name: make[name]() for name in names}


def uncertain_bound_ms(name, dtype):
    """Operations of one predict_uncertain call, as the least work: its
    ψ₂ over the queries (2q + 12 a (query, k, l), as in psi_ops) and the two
    contractions against G and w (4 a (query, k, l) at p = 1), and the
    conditional's statistics: VFE's Kuf·Kufᵀ (2nm²), SVGP's (m, m) solves
    (about 2m³), GPR's K⁻¹ from a Cholesky factor (n³)."""
    n_star, m, q = (Q, SP_M, SP_D) if name != "gpr" else (UP_GPR_QUERIES, UP_GPR_N, D)
    extra = {"vfe": 2 * SP_N * SP_M * SP_M, "svgp": 2 * SP_M ** 3, "gpr": UP_GPR_N ** 3}[name]
    return bound_ms(0, n_star * m * m * (2 * q + 16) + extra, dtype)


def uncertain_prediction_phase(torch):
    """predict_uncertain of VFE and SVGP over 256 queries and of GPR over 16
    (see uncertain_models), float32, fixed jitter policy: the first call and
    the warm CUDA-event time, each finite.  Then the same models in float64
    on the card: at zero input variance each equals its predict_f.  Last,
    VFE's and SVGP's moments at the queries' non-zero input variances for
    the first UP_CPU_QUERIES queries, float32 and float64 on the card,
    against the same models in float64 on the CPU."""
    from gptorch_tpu_torch import settings

    out, moments, sub = {}, {}, slice(0, UP_CPU_QUERIES)
    with settings.override(jitter_policy="fixed"):
        with gram_launch_shapes() as shapes:
            models = uncertain_models(torch, np.float32)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            for name, (model, xq, xv) in models.items():
                t0 = time.perf_counter()
                mu, var = model.predict_uncertain(xq, xv)
                first = 1e3 * (time.perf_counter() - t0)
                check(mu.shape == (xq.shape[0], 1) and var.shape == mu.shape,
                      f"{name} predict_uncertain: wrong shape")
                check(np.isfinite(mu).all() and np.isfinite(var).all(), f"{name} predict_uncertain: non-finite")
                out[name] = {"first_ms": first, "queries": xq.shape[0]}
                moments[name, "f32"] = (mu[sub], var[sub])
            out["launches"] = read_counts()
            out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
            for name, (model, xq, xv) in models.items():
                out[name]["ms"] = time_ms(lambda: model.predict_uncertain(xq, xv), 3)
                out[name]["bound_ms"], out[name]["bound_by"] = uncertain_bound_ms(name, "float32")
                mu_f, var_f = model.predict_f(xq)
                mu_0, var_0 = model.predict_uncertain(xq, np.zeros_like(xv))
                out[name]["f32_zero_var_gap"] = float(max(np.abs(mu_0 - mu_f).max(), np.abs(var_0 - var_f).max()))
                if name != "gpr":
                    with tf32_allowed(torch):
                        moments[name, "tf32"] = model.predict_uncertain(xq[sub], xv[sub])
        out["rbf_gram_shapes"] = shapes
        del models
        torch.cuda.empty_cache()
        with default_dtype(torch, torch.float64):
            for name, (model, xq, xv) in uncertain_models(torch, np.float64).items():
                mu_f, var_f = model.predict_f(xq)
                mu_0, var_0 = model.predict_uncertain(xq, np.zeros_like(xv))
                scale = max(1.0, float(np.abs(mu_f).max()), float(np.abs(var_f).max()))
                out[name]["f64_zero_var_gap"] = float(max(np.abs(mu_0 - mu_f).max(), np.abs(var_0 - var_f).max()))
                out[name]["f64_zero_var_tol"] = F64_REL_TOL * scale
                if name != "gpr":
                    moments[name, "f64"] = model.predict_uncertain(xq[sub], xv[sub])
                del model
                torch.cuda.empty_cache()
            t0 = time.perf_counter()
            for name, (model, xq, xv) in uncertain_models(torch, np.float64, ("vfe", "svgp"), "cpu").items():
                want = model.predict_uncertain(xq[sub], xv[sub])
                for side in ("f32", "f64", "tf32"):
                    out[name][f"{side}_vs_cpu"] = max(float(np.abs(a - b).max() / np.abs(b).max())
                                                      for a, b in zip(moments[name, side], want))
                del model
            out["cpu_s"] = time.perf_counter() - t0
    for name in ("vfe", "svgp", "gpr"):
        r = out[name]
        shape = f"n={SP_N} m={SP_M} d={SP_D}" if name != "gpr" else f"n={UP_GPR_N} d={D}"
        print(f"# uncertain prediction {name} {shape} f32, {r['queries']} queries: first call {r['first_ms']:.3f} ms, "
              f"warm {r['ms']:.3f} ms (bound {r['bound_ms']:.3f} ms, {r['bound_by']}); at zero input variance vs "
              f"predict_f max abs: f32 {r['f32_zero_var_gap']:.3e}, f64 {r['f64_zero_var_gap']:.3e} (tol "
              f"{r['f64_zero_var_tol']:.3e})", flush=True)
        check(r["f64_zero_var_gap"] <= r["f64_zero_var_tol"],
              f"{name} predict_uncertain at zero variance vs predict_f: {r['f64_zero_var_gap']}")
    for name in ("vfe", "svgp"):
        r = out[name]
        print(f"# uncertain prediction {name} at non-zero input variance, first {UP_CPU_QUERIES} queries, vs f64 on "
              f"the CPU: max relative gap of mean and variance f64 card {r['f64_vs_cpu']:.3e} (tol {F64_REL_TOL}), "
              f"f32 card {r['f32_vs_cpu']:.3e} (tol {UP_F32_TOL}; control: f32 with TF32 products "
              f"{r['tf32_vs_cpu']:.3e}, must exceed it)", flush=True)
        check(r["f64_vs_cpu"] <= F64_REL_TOL, f"{name} predict_uncertain f64 card vs CPU: {r['f64_vs_cpu']}")
        check(r["f32_vs_cpu"] <= UP_F32_TOL, f"{name} predict_uncertain f32 card vs f64 CPU: {r['f32_vs_cpu']}")
        check(r["tf32_vs_cpu"] > UP_F32_TOL,
              f"the {name} predict_uncertain limit passes TF32 products ({r['tf32_vs_cpu']})")
    print(f"# uncertain prediction launches {out['launches']}, peak {out['peak_mem_gb']:.2f} GB; the CPU's float64 "
          f"VFE and SVGP {out['cpu_s']:.1f} s", flush=True)
    check(out["launches"]["rbf_gram"] > 0, "the uncertain-prediction path never launched rbf_gram")
    return out


def vecchia_model(n, dtype, device=None, m=VE_M, chunk=VE_CHUNK):
    """bench_vecchia.py's model: x ~ U(0, 1)^3, y = sin(4·Σx) + 0.1ε
    (RandomState(0)), Rbf(3, ARD) with ℓ = 0.3, Gaussian(0.01), m
    neighbours, ``chunk`` rows a step, ordering "auto"."""
    from gptorch_tpu_torch import kernels, likelihoods
    from gptorch_tpu_torch.models import VecchiaGPR

    rng = np.random.RandomState(0)
    x = rng.rand(n, VE_D).astype(dtype)
    y = (np.sin(4.0 * x.sum(axis=1, keepdims=True)) + 0.1 * rng.randn(n, 1)).astype(dtype)
    return VecchiaGPR(x, y, kernels.Rbf(VE_D, ARD=True, length_scales=0.3), likelihood=likelihoods.Gaussian(0.01),
                      num_neighbors=m, chunk=chunk, device=device)


def vecchia_stage_bounds(n, m, d, p, itemsize, dtype):
    """Least times of the forward's three stages over all n rows: the
    gather and Gram write n·m² entries and read n·m·(d + p) (ops: 3d + 3 an
    entry); the batched factor reads and writes n·m² (m³/3 operations a
    row); the solves read the factor once (m²(1 + p) operations a row)."""
    return {"gather_gram": bound_ms((n * m * m + n * m * (d + p)) * itemsize, n * m * m * (3 * d + 3), dtype),
            "factor": bound_ms(2 * n * m * m * itemsize, n * m ** 3 / 3, dtype),
            "solves": bound_ms((n * m * m + n * m * (1 + p)) * itemsize, n * m * m * (1 + p), dtype)}


def vecchia_stages(torch, model):
    """Warm CUDA-event times of the forward's stages summed over the chunks
    (the loss's own loop, split by events): the gather and the masked
    neighbour Gram, the batched factor, the solves with the log density."""
    from gptorch_tpu_torch.functions import _chol_raw
    from gptorch_tpu_torch.ops import vecchia as vops

    X, n = model.X, model.X.shape[0]
    totals = dict.fromkeys(("gather_gram", "factor", "solves"), 0.0)
    with torch.no_grad():
        resid = model.Y - model.mean_function(X)
        noise = model.likelihood.variance.value.reshape(())
        for _ in range(2):  # the first pass warms up
            events = []
            for lo in range(0, n, model.chunk):
                e = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
                idx, msk = model.nn_idx[lo:lo + model.chunk], model.nn_mask[lo:lo + model.chunk]
                e[0].record()
                knn, k_i, kxx = vops.masked_system(model.kernel, noise, X[idx], msk, X[lo:lo + model.chunk])
                e[1].record()
                L = _chol_raw(knn, blocked=False)
                e[2].record()
                mu, var = vops.conditional_solves(L, k_i, msk[:, :, None] * resid[idx], kxx, noise)
                torch.sum(torch.log(var)[:, None] + torch.square(resid[lo:lo + model.chunk] - mu) / var[:, None])
                e[3].record()
                events.append(e)
            torch.cuda.synchronize()
        for e in events:
            for key, (a, b) in zip(totals, ((0, 1), (1, 2), (2, 3))):
                totals[key] += e[a].elapsed_time(e[b])
    return totals


def vecchia_phase(torch):
    """The Vecchia GP at bench_vecchia.py's cell (n = 200000, d = 3, m = 32,
    chunk 8192, f32): the build (ordering and neighbours on the host), a
    warm value-and-grad (CUDA events) and its forward's stages, float32
    against float64 NLML at full n, fit_scan Adam (captured), predict_f of
    8 batches of 256, peak memory; then in float64 full history against the
    dense GPR at n = 512 and the card against the CPU at n = 4096."""
    from gptorch_tpu_torch import kernels
    from gptorch_tpu_torch.ops import vecchia as vops

    out = {"n": VE_N, "d": VE_D, "m": VE_M, "chunk": VE_CHUNK, "dtype": "float32"}
    t0 = time.perf_counter()
    model = vecchia_model(VE_N, np.float32)
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    out["ordering"] = model.ordering
    check(model.device.type == "cuda", "VecchiaGPR did not land on the card")
    rng = np.random.RandomState(7)
    xq = [rng.rand(Q, VE_D).astype(np.float32) for _ in range(BATCHES)]

    zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with gram_launch_shapes() as shapes:
        loss32, grad32 = iterative_value_and_grad(torch, model)
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["value_and_grad_ms"] = time_ms(lambda: iterative_value_and_grad(torch, model), 3)
        stages = vecchia_stages(torch, model)
        bounds = vecchia_stage_bounds(VE_N, VE_M, VE_D, 1, 4, "float32")
        out["stages_ms"] = {k: {"ms": v, "bound_ms": bounds[k][0], "bound_by": bounds[k][1]} for k, v in stages.items()}
        out["forward_ms"] = sum(stages.values())

        # float32 against float64 at full n, at the same values and neighbours;
        # the limit's control has the neighbour Grams rounded to float16
        with torch.no_grad():
            k64 = kernels.Rbf(VE_D, ARD=True, length_scales=0.3).to("cuda").double()
            resid = model.Y - model.mean_function(model.X)
            loss64 = -float(vops.vecchia_nlml(k64, torch.tensor(0.01, dtype=torch.float64, device="cuda"),
                                              model.X.double(), resid.double(), model.nn_idx,
                                              model.nn_mask.double(), chunk=VE_CHUNK))
            controls = {}
            for name, context in (("tf32", tf32_allowed(torch)), ("f16_gram", f16_neighbour_grams())):
                with context:
                    controls[name] = -float(vops.vecchia_nlml(model.kernel, model.likelihood.variance.value, model.X,
                                                              resid, model.nn_idx, model.nn_mask, chunk=VE_CHUNK))
            del k64, resid
        out["f32_vs_f64_rel"] = abs(loss32 - loss64) / abs(loss64)
        out["f32_vs_f64_tol"] = VE_F32_TOL
        out["controls_rel"] = {name: abs(loss - loss64) / abs(loss64) for name, loss in controls.items()}

        t0 = time.perf_counter()
        warm = model.fit_scan("Adam", max_iter=VE_STEPS)
        torch.cuda.synchronize()
        out["fit_scan_warm_s"] = time.perf_counter() - t0
        out["launches_per_captured_step"] = check_captured("vecchia training")
        t0 = time.perf_counter()
        losses = model.fit_scan("Adam", max_iter=VE_STEPS)
        torch.cuda.synchronize()
        out["fit_scan_step_ms"] = 1e3 * (time.perf_counter() - t0) / VE_STEPS
        replayed = replayed_launches()
        out["losses"] = [float(v) for v in torch.cat([warm, losses]).cpu()]
        predict_ms, means, variances = [], [], []
        for xb in xq:
            t0 = time.perf_counter()
            mu, var = model.predict_f(xb)
            predict_ms.append(1e3 * (time.perf_counter() - t0))
            means.append(mu), variances.append(var)
        out["predict_f_ms"] = predict_ms
        out["launches"] = add_counts(read_counts(), replayed)
    out["rbf_gram_shapes"] = shapes
    out["peak_mem_gb"] = max(out["peak_mem_gb"], torch.cuda.max_memory_allocated() / 1e9)
    # the yardstick: Rbf's neighbour Grams mapped by torch.func.vmap, as
    # every other kernel's are
    with vmapped_neighbour_grams(torch):
        yard = {"value_and_grad_ms": time_ms(lambda: iterative_value_and_grad(torch, model), 3),
                "forward_ms": sum(vecchia_stages(torch, model).values())}
        yard_predict = []
        for xb in xq:
            t0 = time.perf_counter()
            model.predict_f(xb)
            yard_predict.append(1e3 * (time.perf_counter() - t0))
        yard["predict_f_ms"] = float(np.median(yard_predict))
    out["vmap_yardstick"] = yard
    mu, var = np.concatenate(means), np.concatenate(variances)
    fwd_bound = sum(b[0] for b in bounds.values())
    print(f"# vecchia n={VE_N} d={VE_D} m={VE_M} chunk={VE_CHUNK} f32 ({out['ordering']} ordering): build "
          f"{out['build_s']:.2f} s (host: ordering, neighbours, k-d tree); value-and-grad "
          f"{out['value_and_grad_ms']:.2f} ms (forward's stages {out['forward_ms']:.2f} ms, bound {fwd_bound:.3f} ms); "
          f"fit_scan Adam (captured, "
          f"launches recorded per captured step {out['launches_per_captured_step']}) warm call of {VE_STEPS} steps "
          f"{out['fit_scan_warm_s']:.2f} s, timed {out['fit_scan_step_ms']:.2f} ms/step; predict_f per batch of {Q} "
          f"median {np.median(predict_ms):.3f} ms; peak {out['peak_mem_gb']:.2f} GB; launches {out['launches']}; "
          f"NLML f32 {-loss32:.3f} vs f64 {-loss64:.3f}, relative {out['f32_vs_f64_rel']:.3e} (tol "
          f"{out['f32_vs_f64_tol']:.3e}; control: f32 with the neighbour Grams in float16 "
          f"{out['controls_rel']['f16_gram']:.3e}, must exceed it; with TF32 products allowed "
          f"{out['controls_rel']['tf32']:.3e})", flush=True)
    for key, s in out["stages_ms"].items():
        print(f"# vecchia stage {key}: {s['ms']:.3f} ms (bound {s['bound_ms']:.4f} ms, {s['bound_by']})", flush=True)
    print(f"# vecchia yardstick, Rbf's neighbour Grams mapped by torch.func.vmap: value-and-grad "
          f"{yard['value_and_grad_ms']:.2f} ms (the batched route {out['value_and_grad_ms']:.2f}), forward's stages "
          f"{yard['forward_ms']:.2f} ms ({out['forward_ms']:.2f}), predict_f per batch of {Q} median "
          f"{yard['predict_f_ms']:.3f} ms ({np.median(predict_ms):.3f})", flush=True)
    check(all(math.isfinite(v) for v in out["losses"]) and np.isfinite(grad32).all(), "non-finite Vecchia loss")
    check(out["losses"][-1] < out["losses"][0], "Vecchia training did not lower the loss")
    check(out["f32_vs_f64_rel"] <= out["f32_vs_f64_tol"], f"Vecchia f32 vs f64 NLML: {out['f32_vs_f64_rel']}")
    check(out["launches"]["rbf_gram"] > 0, "the Vecchia path never launched rbf_gram")
    check(out["controls_rel"]["f16_gram"] > out["f32_vs_f64_tol"],
          f"the Vecchia limit passes the NLML with float16 Grams ({out['controls_rel']['f16_gram']})")
    check(mu.shape == (Q * BATCHES, 1) and np.isfinite(mu).all() and np.isfinite(var).all() and (var >= 0).all(),
          "Vecchia predict_f: wrong shape, non-finite or negative variance")
    del model
    torch.cuda.empty_cache()
    out["full_history"] = vecchia_full_history(torch)
    out["card_vs_cpu"] = vecchia_card_vs_cpu(torch)
    return out


def vecchia_full_history(torch):
    """Float64 on the card, n = 512: with every previous point a neighbour
    the Vecchia NLML and gradient are the dense GPR's (the chain rule)."""
    from gptorch_tpu_torch import kernels, likelihoods
    from gptorch_tpu_torch.models import GPR

    with default_dtype(torch, torch.float64):
        v = vecchia_model(VE_DENSE_N, np.float64, m=VE_DENSE_N - 1, chunk=VE_DENSE_N)
        dense = GPR(v.X, v.Y, kernels.Rbf(VE_D, ARD=True, length_scales=0.3), likelihood=likelihoods.Gaussian(0.01),
                    fast=False)
        (lv, gv), (ld, gd) = iterative_value_and_grad(torch, v), iterative_value_and_grad(torch, dense)
    out = {"loss_rel": abs(lv - ld) / abs(ld), "grad_rel": float(np.abs(gv - gd).max() / np.abs(gd).max())}
    print(f"# vecchia f64 full history (m = n - 1 = {VE_DENSE_N - 1}) vs dense GPR on the card: NLML relative "
          f"{out['loss_rel']:.3e} (tol 1e-10), gradient {out['grad_rel']:.3e} (tol {F64_REL_TOL})", flush=True)
    check(out["loss_rel"] <= 1e-10, f"Vecchia full history vs dense NLML: {out['loss_rel']}")
    check(out["grad_rel"] <= F64_REL_TOL, f"Vecchia full history vs dense gradient: {out['grad_rel']}")
    return out


def vecchia_card_vs_cpu(torch):
    """Float64, n = 4096 (maxmin ordering), m = 32, chunk 1024: the card's
    loss, gradient and predict_f of 256 queries against the CPU's, to
    F64_REL_TOL."""
    rng = np.random.RandomState(8)
    xq = rng.rand(Q, VE_D)
    runs = {}
    with default_dtype(torch, torch.float64):
        for device in ("cuda", "cpu"):
            model = vecchia_model(VE_CHECK_N, np.float64, device=device, chunk=1024)
            loss, grad = iterative_value_and_grad(torch, model)
            runs[device] = (np.array([loss]), grad, *model.predict_f(xq))
    rels = [float(np.abs(a - b).max() / np.abs(b).max()) for a, b in zip(runs["cuda"], runs["cpu"])]
    print(f"# vecchia f64 card vs CPU n={VE_CHECK_N} m={VE_M}: max relative gaps loss {rels[0]:.3e}, gradient "
          f"{rels[1]:.3e}, predict_f mean {rels[2]:.3e}, var {rels[3]:.3e} (tol {F64_REL_TOL})", flush=True)
    check(max(rels) <= F64_REL_TOL, f"Vecchia card vs CPU: {rels}")
    return rels


def latent_and_vecchia_phases(torch):
    """The ψ-statistics, GPLVM, uncertain-prediction and Vecchia paths, each
    driven with the launch counts set to 0 just before it and read just
    after, and K1's shapes on them checked against gram_phase's cases;
    returns their results and the seconds they took together."""
    t0 = time.perf_counter()
    out = {"psi_statistics": psi_statistics_phase(torch), "gplvm": gplvm_phase(torch),
           "uncertain_prediction": uncertain_prediction_phase(torch), "vecchia": vecchia_phase(torch)}
    check_gram_coverage(set().union(*(result["rbf_gram_shapes"] for result in out.values())))
    seconds = time.perf_counter() - t0
    print(f"# psi statistics, gplvm, uncertain prediction and vecchia phases: {seconds:.1f} s together",
          flush=True)
    return out, seconds


# -- the structured exact GPs: state space, Kronecker grid, SKI ------------------------


def rel_gap(a, b):
    """max |a − b| over max |b| (arrays or scalars)."""
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def ssgp_data(n, seed=0):
    """bench_ssgp.py's data: x ~ U(0, 1000) sorted, y = sin(0.5x) + 0.3ε
    (RandomState(0)), float32."""
    rng = np.random.RandomState(seed)
    x = np.sort(rng.uniform(0.0, 1000.0, n)).astype(np.float32)[:, None]
    y = (np.sin(0.5 * x) + 0.3 * rng.randn(n, 1)).astype(np.float32)
    return x, y


def ssgp_kernel(kernels, name="matern32"):
    """bench_ssgp.py's kernels (variance 1, ℓ = 0.5), and the s = 5 Sum."""
    if name == "matern32+matern52":
        return ssgp_kernel(kernels, "matern32") + ssgp_kernel(kernels, "matern52")
    cls = {"matern12": kernels.Matern12, "matern32": kernels.Matern32, "matern52": kernels.Matern52}[name]
    return cls(1, variance=1.0, length_scales=0.5)


def ssgp_model(torch, n, dtype, name="matern32", device=None):
    """StateSpaceGPR on ssgp_data(n) in ``dtype`` (the float32 data cast),
    Gaussian(0.1); Params in ``dtype``."""
    from gptorch_tpu_torch import kernels, likelihoods
    from gptorch_tpu_torch.models import StateSpaceGPR

    x, y = ssgp_data(n)
    with default_dtype(torch, torch.float64 if dtype == np.float64 else torch.float32):
        return StateSpaceGPR(x.astype(dtype), y.astype(dtype), ssgp_kernel(kernels, name),
                             likelihood=likelihoods.Gaussian(0.1), device=device)


def ssgp_combine_ops(s, dy):
    """Operations of one filtering combine: nine (s, s) products, five
    (s, s)·(s, dy) products and the element-wise rest, a fused
    multiply-add counted as two."""
    return 18 * s ** 3 + 10 * s * s * dy + 8 * s * s


def ssgp_stage_bounds(n, s, dy, itemsize, dtype):
    """Least times of the forward's stages: assemble reads x and writes A and
    Q; the element build reads A, Q, y and writes the five elements; the
    scan reads them and writes as many prefixes, with 2(n − 1) combines;
    the NLML reads A, Q, y and the filtered moments; the smoother reads
    those and writes the smoothed moments, with n − 1 combines."""
    elem = 3 * s * s + 2 * s * dy
    moments = s * s + s * dy
    return {"assemble": bound_ms(n * (1 + 2 * s * s) * itemsize, n * 4 * s ** 3, dtype),
            "elements": bound_ms(n * (2 * s * s + dy + elem) * itemsize, n * 12 * s ** 3, dtype),
            "scan": bound_ms(2 * n * elem * itemsize, 2 * n * ssgp_combine_ops(s, dy), dtype),
            "nlml": bound_ms(n * (2 * s * s + dy + moments) * itemsize, n * 6 * s ** 3, dtype),
            "smoother": bound_ms(n * (2 * s * s + 2 * moments) * itemsize, n * (ssgp_combine_ops(s, dy) + 12 * s ** 3),
                                 dtype)}


def ssgp_value_and_grad_bound(n, s, dy, itemsize, dtype):
    """The value-and-grad's least time: x and y read once (the gradient's
    few entries written); the forward's combines (2(n − 1), and the
    element build) and a backward of twice the forward's operations."""
    return bound_ms(n * (1 + dy) * itemsize, 3 * n * (2 * ssgp_combine_ops(s, dy) + 12 * s ** 3), dtype)


def ssgp_stages(torch, model):
    """Warm CUDA-event times of the forward's stages (no gradient), each
    through the function the loss calls, on the outputs of the stage before."""
    from gptorch_tpu_torch.ops import ssm

    with torch.no_grad():
        x, resid, R, chunk = model.X[:, 0], model.Y - model.mean_function(model.X), model._noise(), model._scan_chunk
        A, Q, H, _ = ssm.assemble_sde(model.kernel, x)
        elems = ssm.filter_elements(A, Q, H, R, resid)
        prefix = ssm._scan_prefix(elems, chunk)
        means, covs = ssm._untb(prefix[1]), ssm._untb(prefix[2])
        stages = {
            "assemble": lambda: ssm.assemble_sde(model.kernel, x),
            "elements": lambda: ssm.filter_elements(A, Q, H, R, resid),
            "scan": lambda: ssm._scan_prefix(elems, chunk),
            "nlml": lambda: ssm.filter_nlml(A, Q, H, R, resid, means, covs),
            "smoother": lambda: ssm.parallel_smoother(A, Q, means, covs),
        }
        out = {name: time_ms(fn, 3) for name, fn in stages.items()}
    del A, Q, elems, prefix, means, covs
    return out


def ssgp_f32_vs_f64(torch, model, n):
    """The float32 model's NLML and gradient against the same data and
    values in float64 on the card: (NLML relative gap, gradient gap over
    its largest entry)."""
    loss32, grad32 = iterative_value_and_grad(torch, model)
    m64 = ssgp_model(torch, n, np.float64)
    loss64, grad64 = iterative_value_and_grad(torch, m64)
    del m64
    torch.cuda.empty_cache()
    return abs(loss32 - loss64) / abs(loss64), rel_gap(grad32, grad64)


def ssgp_card_vs_cpu(torch):
    """Float64, n = 4096: the loss and gradient on the card against the
    CPU for each of SS_KERNELS, monolithic and chunked (SS_CHECK_CHUNK,
    through GPTORCH_TPU_SSM_CHUNK); the worst relative gap."""
    worst = 0.0
    for name in SS_KERNELS:
        for chunk in ("0", str(SS_CHECK_CHUNK)):
            runs = []
            os.environ["GPTORCH_TPU_SSM_CHUNK"] = chunk
            try:
                for device in ("cuda", "cpu"):
                    with default_dtype(torch, torch.float64):
                        runs.append(iterative_value_and_grad(torch, ssgp_model(torch, SS_CHECK_N, np.float64, name,
                                                                                device=device)))
            finally:
                del os.environ["GPTORCH_TPU_SSM_CHUNK"]
            gaps = (rel_gap(runs[0][0], runs[1][0]), rel_gap(runs[0][1], runs[1][1]))
            print(f"# statespace f64 card vs CPU n={SS_CHECK_N} {name} chunk={chunk}: loss {gaps[0]:.3e}, "
                  f"gradient {gaps[1]:.3e}", flush=True)
            worst = max(worst, *gaps)
    check(worst <= F64_REL_TOL, f"statespace card vs CPU: {worst}")
    return worst


def ssgp_vs_dense(torch):
    """Float64 on the card, n = 2048: the state-space NLML against the dense
    GPR's (1e-9 relative, the JAX test's limit) and their gradients."""
    from gptorch_tpu_torch import kernels, likelihoods
    from gptorch_tpu_torch.models import GPR

    ss = ssgp_model(torch, SS_DENSE_N, np.float64)
    with default_dtype(torch, torch.float64):
        dense = GPR(ss.X, ss.Y, ssgp_kernel(kernels), likelihood=likelihoods.Gaussian(0.1), fast=False)
        (ls, gs), (ld, gd) = iterative_value_and_grad(torch, ss), iterative_value_and_grad(torch, dense)
    out = {"loss_rel": abs(ls - ld) / abs(ld), "grad_rel": rel_gap(gs, gd)}
    print(f"# statespace f64 vs dense GPR n={SS_DENSE_N} on the card: NLML relative {out['loss_rel']:.3e} (tol 1e-9), "
          f"gradient {out['grad_rel']:.3e} (tol 1e-6)", flush=True)
    check(out["loss_rel"] <= 1e-9 and out["grad_rel"] <= 1e-6, f"statespace vs dense GPR: {out}")
    return out


def statespace_phase(torch):
    """The state-space GP at bench_ssgp.py's cell; see the module docstring,
    phase 20."""
    from gptorch_tpu_torch import settings

    out = {"n": SS_N, "dtype": "float32", "kernel": "matern32"}
    model = ssgp_model(torch, SS_N, np.float32)
    check(model.device.type == "cuda", "StateSpaceGPR did not land on the card")
    rng = np.random.RandomState(11)
    xq = [np.sort(rng.uniform(0.0, 1000.0, Q)).astype(np.float32)[:, None] for _ in range(BATCHES)]
    zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with gram_launch_shapes() as shapes:
        iterative_value_and_grad(torch, model)
        out["value_and_grad_ms"] = [time_ms(lambda: iterative_value_and_grad(torch, model), 1) for _ in range(2)]
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        _, out["busy_ms"], _, out["launches_per_value_and_grad"] = device_busy_ms(
            torch, lambda: iterative_value_and_grad(torch, model))
        out["stages_ms"] = ssgp_stages(torch, model)
        out["f32_vs_f64"] = ssgp_f32_vs_f64(torch, model, SS_N)

        t0 = time.perf_counter()
        warm = model.fit_scan("Adam", max_iter=SS_STEPS)
        torch.cuda.synchronize()
        out["fit_scan_warm_s"] = time.perf_counter() - t0
        out["launches_per_captured_step"] = check_captured("statespace training")
        t0 = time.perf_counter()
        losses = model.fit_scan("Adam", max_iter=SS_STEPS)
        torch.cuda.synchronize()
        out["fit_scan_step_ms"] = 1e3 * (time.perf_counter() - t0) / SS_STEPS
        replayed = replayed_launches()
        out["losses"] = [float(v) for v in torch.cat([warm, losses]).cpu()]
        out["predict_f_ms"], moments = [], []
        for xb in xq:
            t0 = time.perf_counter()
            moments.append(model.predict_f(xb))
            out["predict_f_ms"].append(1e3 * (time.perf_counter() - t0))
        gen = torch.Generator(device="cuda").manual_seed(0)
        t0 = time.perf_counter()
        draws = model.predict_f_samples(xq[0], SS_SAMPLES, generator=gen)
        out["samples_ms"] = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        f_mean, f_var = model.filter_moments()
        torch.cuda.synchronize()
        out["filter_moments_ms"] = 1e3 * (time.perf_counter() - t0)
        moment_draws = model.predict_f_samples(xq[0], SS_MOMENT_SAMPLES, generator=gen)
        out["launches"] = add_counts(read_counts(), replayed)
    out["rbf_gram_shapes"] = shapes
    out["peak_mem_gb"] = max(out["peak_mem_gb"], torch.cuda.max_memory_allocated() / 1e9)
    mean0, var0 = moments[0]
    out["sample_moments"] = sample_moments(moment_draws, mean0, var0, "statespace")
    s = 2
    vg_bound = ssgp_value_and_grad_bound(SS_N, s, 1, 4, "float32")
    stage_bounds = ssgp_stage_bounds(SS_N, s, 1, 4, "float32")
    out["value_and_grad_bound"] = vg_bound
    out["stage_bounds"] = stage_bounds
    vg_ms = ", ".join(f"{t:.2f}" for t in out["value_and_grad_ms"])
    print(f"# statespace n={SS_N} matern32 f32: value-and-grad {vg_ms} ms "
          f"(bound {vg_bound[0]:.4f} ms, {vg_bound[1]}; {out['launches_per_value_and_grad']} device launches, busy "
          f"{out['busy_ms']:.2f} ms); fit_scan Adam (captured, launches recorded per captured step "
          f"{out['launches_per_captured_step']}) warm call of {SS_STEPS} steps {out['fit_scan_warm_s']:.2f} s, timed "
          f"{out['fit_scan_step_ms']:.3f} ms/step; predict_f per batch of {Q} median "
          f"{np.median(out['predict_f_ms']):.2f} ms; predict_f_samples({SS_SAMPLES}) over {Q} "
          f"{out['samples_ms']:.2f} ms; "
          f"filter_moments {out['filter_moments_ms']:.2f} ms; peak {out['peak_mem_gb']:.3f} GB; NLML f32 vs f64 "
          f"relative {out['f32_vs_f64'][0]:.3e} (tol {SS_F32_TOL[SS_N]['nlml']}), gradient {out['f32_vs_f64'][1]:.3e} "
          f"(tol {SS_F32_TOL[SS_N]['grad']})", flush=True)
    for key, ms in out["stages_ms"].items():
        print(f"# statespace stage {key}: {ms:.3f} ms (bound {stage_bounds[key][0]:.5f} ms, {stage_bounds[key][1]})",
              flush=True)
    check(all(math.isfinite(v) for v in out["losses"]), "non-finite state-space loss")
    check(out["losses"][-1] < out["losses"][0], "state-space training did not lower the loss")
    check(out["f32_vs_f64"][0] <= SS_F32_TOL[SS_N]["nlml"] and out["f32_vs_f64"][1] <= SS_F32_TOL[SS_N]["grad"],
          f"statespace f32 vs f64 at n={SS_N}: {out['f32_vs_f64']}")
    mu = np.concatenate([m for m, _ in moments])
    var = np.concatenate([v for _, v in moments])
    check(mu.shape == (Q * BATCHES, 1) and np.isfinite(mu).all() and (var >= 0).all(), "statespace predict_f")
    check(draws.shape == (SS_SAMPLES, Q, 1) and np.isfinite(draws).all(), "statespace predict_f_samples")
    check(bool(torch.isfinite(f_mean).all()) and bool((f_var >= 0).all()), "statespace filter_moments")
    del model, draws, moment_draws, f_mean, f_var
    torch.cuda.empty_cache()

    long = ssgp_model(torch, SS_N_LONG, np.float32)
    torch.cuda.reset_peak_memory_stats()
    iterative_value_and_grad(torch, long)
    out["long"] = {"n": SS_N_LONG, "chunk": long._scan_chunk,
                   "value_and_grad_ms": time_ms(lambda: iterative_value_and_grad(torch, long), 1),
                   "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "bound": ssgp_value_and_grad_bound(SS_N_LONG, s, 1, 4, "float32")}
    _, out["long"]["busy_ms"], _, out["long"]["launches_per_value_and_grad"] = device_busy_ms(
        torch, lambda: iterative_value_and_grad(torch, long))
    out["long"]["f32_vs_f64"] = ssgp_f32_vs_f64(torch, long, SS_N_LONG)
    lg = out["long"]
    print(f"# statespace n={SS_N_LONG} (chunk {lg['chunk']}) f32: value-and-grad {lg['value_and_grad_ms']:.2f} ms "
          f"(bound "
          f"{lg['bound'][0]:.4f} ms, {lg['bound'][1]}; {lg['launches_per_value_and_grad']} device launches, busy "
          f"{lg['busy_ms']:.2f} ms); peak {lg['peak_mem_gb']:.3f} GB; NLML f32 vs f64 relative "
          f"{lg['f32_vs_f64'][0]:.3e} "
          f"(tol {SS_F32_TOL[SS_N_LONG]['nlml']}), gradient {lg['f32_vs_f64'][1]:.3e} (tol "
          f"{SS_F32_TOL[SS_N_LONG]['grad']})", flush=True)
    check(lg["f32_vs_f64"][0] <= SS_F32_TOL[SS_N_LONG]["nlml"] and lg["f32_vs_f64"][1] <= SS_F32_TOL[SS_N_LONG]["grad"],
          f"statespace f32 vs f64 at n={SS_N_LONG}: {lg['f32_vs_f64']}")
    del long
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = ssgp_card_vs_cpu(torch)
    out["vs_dense"] = ssgp_vs_dense(torch)
    return out


def grid_data(sizes, seed=0):
    """Axes on [0, 10] with the given sizes and y = sin(x₀)·cos(x₁) +
    0.05·x₂ + 0.1ε on the grid (RandomState(seed)), float64."""
    from gptorch_tpu_torch.models.kronecker import grid_points

    rng = np.random.RandomState(seed)
    axes = [np.linspace(0.0, 10.0, n) for n in sizes]
    x = grid_points(axes)
    y = np.sin(x[:, :1]) * np.cos(x[:, 1:2]) + 0.05 * x[:, 2:3] + 0.1 * rng.randn(x.shape[0], 1)
    return axes, y


def grid_model(torch, sizes, dtype, device=None):
    """GridGPR with Rbf(1) per axis and Gaussian(0.1), Params in ``dtype``."""
    from gptorch_tpu_torch import kernels, likelihoods
    from gptorch_tpu_torch.models import GridGPR

    axes, y = grid_data(sizes)
    with default_dtype(torch, torch.float64 if dtype == np.float64 else torch.float32):
        return GridGPR(axes, y.astype(dtype), [kernels.Rbf(1) for _ in sizes], likelihood=likelihoods.Gaussian(0.1),
                       device=device)


def grid_bounds(n, D, dy, itemsize, dtype):
    """Least times: the value-and-grad reads y once and does D mode products
    of 2·n·N operations each forward (three times that with the backward);
    one eigh of an (n, n) axis Gram (~9n³ operations); 8·256 queries each
    read the alpha grid once."""
    N = n ** D
    return {"value_and_grad": bound_ms(N * dy * itemsize, 3 * D * 2 * n * N * dy, dtype),
            "eigh": bound_ms(2 * n * n * itemsize, 9 * n ** 3, dtype),
            "mode_products": bound_ms(2 * N * dy * itemsize, D * 2 * n * N * dy, dtype),
            "predict_batch": bound_ms(N * dy * itemsize, 2 * Q * N * dy, dtype)}


def kronecker_phase(torch):
    """The Kronecker grid GP; see the module docstring, phase 21."""
    sizes = (KR_SIZE,) * 3
    out = {"grid": sizes, "dtype": "float32"}
    model = grid_model(torch, sizes, np.float32)
    check(model.device.type == "cuda", "GridGPR did not land on the card")
    rng = np.random.RandomState(12)
    xq = [rng.uniform(0.0, 10.0, (Q, 3)).astype(np.float32) for _ in range(BATCHES)]
    zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with gram_launch_shapes() as shapes:
        loss32, grad32 = iterative_value_and_grad(torch, model)
        out["value_and_grad_ms"] = time_ms(lambda: iterative_value_and_grad(torch, model), 3)
        _, out["busy_ms"], _, out["launches_per_value_and_grad"] = device_busy_ms(
            torch, lambda: iterative_value_and_grad(torch, model))
        with torch.no_grad():
            lams, qs = model._eigs()
            yt = model.Y.reshape(model.grid_sizes + (1,))
            out["stages_ms"] = {"eigh x3 (with K1)": time_ms(model._eigs, 3),
                                "mode_products": time_ms(lambda: model._mode_products(yt, [q.T for q in qs]), 3)}
        t0 = time.perf_counter()
        losses = model.fit_scan("Adam", max_iter=KR_STEPS)
        torch.cuda.synchronize()
        out["fit_scan_step_ms"] = 1e3 * (time.perf_counter() - t0) / KR_STEPS
        from gptorch_tpu_torch.training import fit

        check(not fit.fit_scan.last_run["captured"], "GridGPR's fit_scan was captured (eigh reads the host)")
        out["losses"] = [float(v) for v in losses.cpu()]
        t0 = time.perf_counter()
        post = model.posterior()
        torch.cuda.synchronize()
        out["posterior_ms"] = 1e3 * (time.perf_counter() - t0)
        out["predict_f_ms"], moments = [], []
        for xb in xq:
            t0 = time.perf_counter()
            moments.append(post.predict_f(xb))
            out["predict_f_ms"].append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
        full_mean, full_cov = post.predict_f(xq[0][:KR_FULL_QUERIES], diag=False)
        out["predict_full_ms"] = 1e3 * (time.perf_counter() - t0)
        out["launches"] = read_counts()
    out["rbf_gram_shapes"] = shapes
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    bounds = grid_bounds(KR_SIZE, 3, 1, 4, "float32")
    out["bounds"] = bounds
    print(f"# kronecker grid {KR_SIZE}^3 (N = {KR_SIZE ** 3}) Rbf(1) per axis f32: value-and-grad "
          f"{out['value_and_grad_ms']:.3f} ms (bound {bounds['value_and_grad'][0]:.4f} ms, "
          f"{bounds['value_and_grad'][1]}; {out['launches_per_value_and_grad']} device launches, busy "
          f"{out['busy_ms']:.3f} ms); stages {', '.join(f'{k} {v:.3f} ms' for k, v in out['stages_ms'].items())} (one "
          f"eigh's bound {bounds['eigh'][0]:.5f} ms, the mode products' {bounds['mode_products'][0]:.4f} ms); fit_scan "
          f"Adam (eager) {out['fit_scan_step_ms']:.2f} ms/step; posterior() {out['posterior_ms']:.2f} ms; "
          f"predict_f per "
          f"batch of {Q} median {np.median(out['predict_f_ms']):.3f} ms (bound {bounds['predict_batch'][0]:.4f} ms); "
          f"diag=False at {KR_FULL_QUERIES} {out['predict_full_ms']:.2f} ms; peak {out['peak_mem_gb']:.3f} GB; "
          f"launches "
          f"{out['launches']}", flush=True)
    mu = np.concatenate([m for m, _ in moments])
    var = np.concatenate([v for _, v in moments])
    check(np.isfinite(loss32) and np.isfinite(grad32).all() and all(math.isfinite(v) for v in out["losses"]),
          "non-finite grid GP loss")
    check(out["losses"][-1] < out["losses"][0], "grid GP training did not lower the loss")
    check(mu.shape == (Q * BATCHES, 1) and np.isfinite(mu).all() and (var >= 0).all(), "grid GP predict_f")
    check(full_cov.shape == (KR_FULL_QUERIES, KR_FULL_QUERIES) and np.isfinite(full_cov).all(),
          "grid GP full covariance")
    check(out["launches"]["rbf_gram"] > 0, "the Kronecker path never launched rbf_gram")
    del model, post
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = kronecker_card_vs_cpu(torch)
    return out


def kronecker_card_vs_cpu(torch):
    """Float64 on a 16 × 12 × 10 grid: the card's loss, gradient and
    predict_f (diagonal and full) against the CPU's, and the card's against
    the dense GPR with the product kernel (each Rbf on its column), all to
    F64_REL_TOL."""
    from gptorch_tpu_torch import kernels, likelihoods
    from gptorch_tpu_torch.models import GPR
    from gptorch_tpu_torch.models.kronecker import grid_points

    xq = np.random.RandomState(13).uniform(0.0, 10.0, (32, 3))
    runs = {}
    for device in ("cuda", "cpu"):
        model = grid_model(torch, KR_CHECK_SIZES, np.float64, device=device)
        with default_dtype(torch, torch.float64):
            loss, grad = iterative_value_and_grad(torch, model)
            runs[device] = (np.array([loss]), grad, *model.predict_f(xq), *model.predict_f(xq[:8], diag=False))
    rels = [rel_gap(a, b) for a, b in zip(runs["cuda"], runs["cpu"])]
    axes, y = grid_data(KR_CHECK_SIZES)
    with default_dtype(torch, torch.float64):
        product = (kernels.ActiveDims(kernels.Rbf(1), [0], 3) * kernels.ActiveDims(kernels.Rbf(1), [1], 3)
                   * kernels.ActiveDims(kernels.Rbf(1), [2], 3))
        dense = GPR(grid_points(axes), y, product, likelihood=likelihoods.Gaussian(0.1), fast=False)
        ld, _ = iterative_value_and_grad(torch, dense)
        dense_moments = dense.predict_f(xq)
    vs_dense = [abs(runs["cuda"][0][0] - ld) / abs(ld)] + [rel_gap(a, b) for a, b in zip(runs["cuda"][2:4],
                                                                                          dense_moments)]
    print(f"# kronecker f64 grid {KR_CHECK_SIZES}: card vs CPU max relative gaps loss {rels[0]:.3e}, gradient "
          f"{rels[1]:.3e}, predict_f mean {rels[2]:.3e}, var {rels[3]:.3e}, full mean {rels[4]:.3e}, cov "
          f"{rels[5]:.3e}; "
          f"card vs dense GPR (product kernel): loss {vs_dense[0]:.3e}, mean {vs_dense[1]:.3e}, var {vs_dense[2]:.3e} "
          f"(tol {F64_REL_TOL})", flush=True)
    check(max(rels) <= F64_REL_TOL and max(vs_dense) <= F64_REL_TOL, f"Kronecker f64 checks: {rels}, {vs_dense}")
    return {"card_vs_cpu": rels, "vs_dense": vs_dense}


def ski_data(n, nt, seed=0, noise=0.1):
    """bench_calibration.make_data's 3-D recipe: x ~ U(−1, 1)³,
    f = sin(2x₀) + cos(3x₁) + 0.5x₂², y = f + noise·ε, a random split into
    n training points (sorted indices) and nt test points."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1.0, 1.0, (n + nt, 3))
    f = np.sin(2.0 * x[:, :1]) + np.cos(3.0 * x[:, 1:2]) + 0.5 * x[:, 2:3] ** 2
    y = f + noise * rng.randn(*f.shape)
    idx = rng.permutation(n + nt)
    tr, te = np.sort(idx[:n]), idx[n:]
    return x[tr], y[tr], x[te], y[te]


def ski_model(torch, n, dtype, device=None, noise=0.01, **kw):
    """bench_calibration.py's 3-D SKI row: Matern32(1, ℓ = 0.5) per axis,
    grid 16³, Gaussian(noise), the SKIGPR defaults unless ``kw`` says
    otherwise; (model, test inputs)."""
    from gptorch_tpu_torch import kernels, likelihoods
    from gptorch_tpu_torch.models import SKIGPR

    x, y, xt, _ = ski_data(n, Q * BATCHES)
    with default_dtype(torch, torch.float64 if dtype == np.float64 else torch.float32):
        model = SKIGPR(x.astype(dtype), y.astype(dtype), [kernels.Matern32(1, length_scales=0.5) for _ in range(3)],
                       grid_shape=SKI_GRID, likelihood=likelihoods.Gaussian(noise), device=device, **kw)
    return model, xt.astype(dtype)


def ski_bounds(n, G, k, t, steps, itemsize, dtype):
    """Least times: Wᵀ and W each read the stencil (k entries a row: an
    int64 index and a weight) and the n·t values once and write their
    output once; the Toeplitz FFTs read and write the (G, t) grid (and
    15·G·log₂(2g)·t operations for three axes of real FFTs); the product is
    the three; an mBCG step is one product and ~10 passes over (n, t)
    vectors; SLQ's eigh of (t, steps, steps) about 9·steps³ operations a
    matrix; the value-and-grad is mBCG, SLQ and four more products."""
    stencil = n * k * (8 + itemsize)
    interp = bound_ms(stencil + (n + G) * t * itemsize, 2 * n * k * t, dtype)
    fft = bound_ms(2 * G * t * itemsize, 15 * G * math.log2(2 * round(G ** (1 / 3))) * t, dtype)
    product = (2 * interp[0] + fft[0], interp[1])
    step = bound_ms(2 * stencil + 10 * n * t * itemsize, 4 * n * k * t + 10 * n * t, dtype)
    slq = bound_ms(t * steps * steps * itemsize, 9 * t * steps ** 3, dtype)
    return {"scatter (W^T)": interp, "toeplitz fft": fft, "gather (W)": interp, "product": product,
            "mbcg": (steps * step[0], step[1]), "slq": slq,
            "value_and_grad": (steps * step[0] + slq[0] + 4 * product[0], step[1])}


def ski_stages(torch, model):
    """Warm CUDA-event times of one (W K_g Wᵀ + σ²I) product on the
    mBCG's (n, 1 + probes) block split into Wᵀ, the Toeplitz FFTs and W;
    the mBCG of the loss; the SLQ on its coefficients."""
    from gptorch_tpu_torch.ops import iterative, ski

    with torch.no_grad():
        rows, noise = model._rows(), model._noise()
        B = torch.cat([model.Y, model.probes], 1)
        u = ski.interp_rmatvec(model._train_idx, model._train_w, B, model.num_grid, plan=model._plan)
        g = ski.kron_toeplitz_matvec(rows, u, model.grid_shape)
        _, alphas, betas, valid = model._cg(rows, noise, B)
        sq = torch.sum(model.probes * model.probes, dim=0)
        stages = {
            "scatter (W^T)": (lambda: ski.interp_rmatvec(model._train_idx, model._train_w, B, model.num_grid,
                                                         plan=model._plan), 5),
            "toeplitz fft": (lambda: ski.kron_toeplitz_matvec(rows, u, model.grid_shape), 5),
            "gather (W)": (lambda: ski.interp_matvec(model._train_idx, model._train_w, g), 5),
            "product": (lambda: model._mvm(rows, noise, B), 5),
            "mbcg": (lambda: model._cg(rows, noise, B), 1),
            "slq": (lambda: iterative.lanczos_logdet_quadratic(alphas[:, 1:], betas[:, 1:], valid[:, 1:], sq,
                                                               model.X.shape[0]), 3),
        }
        out = {name: time_ms(fn, reps) for name, (fn, reps) in stages.items()}
        out["cg_steps_used"] = int(valid.sum(0).max())
    return out


def ski_phase(torch):
    """SKI at bench_calibration.py's 3-D row; see the module docstring,
    phase 22."""
    from gptorch_tpu_torch.module import get_trainable
    from gptorch_tpu_torch.training import fit

    model, xt = ski_model(torch, SKI_N, np.float32)
    check(model.device.type == "cuda", "SKIGPR did not land on the card")
    out = {"n": SKI_N, "grid": model.grid_shape, "dtype": "float32", "probes": model.num_probes,
           "cg_steps": model.max_cg_iters}
    xq = [xt[i * Q:(i + 1) * Q] for i in range(BATCHES)]
    zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with gram_launch_shapes() as shapes:
        first = iterative_value_and_grad(torch, model)
        second = iterative_value_and_grad(torch, model)
        out["bitwise_equal"] = first[0] == second[0] and np.array_equal(first[1], second[1])
        out["value_and_grad_ms"] = time_ms(lambda: iterative_value_and_grad(torch, model), 1)
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        _, out["busy_ms"], _, out["launches_per_value_and_grad"] = device_busy_ms(
            torch, lambda: iterative_value_and_grad(torch, model))
        out["stages_ms"] = ski_stages(torch, model)
        t0 = time.perf_counter()
        post = model.posterior()
        torch.cuda.synchronize()
        out["posterior_ms"] = 1e3 * (time.perf_counter() - t0)
        out["predict_mean_ms"], means = [], []
        for xb in xq:
            t0 = time.perf_counter()
            means.append(post.predict_mean(xb))
            out["predict_mean_ms"].append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
        f_mean, f_var = post.predict_f(xq[0][:SKI_CG_QUERIES])
        out["predict_f_ms"] = 1e3 * (time.perf_counter() - t0)
        out["launches"] = read_counts()
    out["rbf_gram_shapes"] = shapes
    out["peak_mem_gb"] = max(out["peak_mem_gb"], torch.cuda.max_memory_allocated() / 1e9)
    t = 1 + model.num_probes
    bounds = ski_bounds(SKI_N, model.num_grid, 4 ** 3, t, model.max_cg_iters, 4, "float32")
    out["bounds"] = bounds
    print(f"# ski n={SKI_N} grid {SKI_GRID}^3 f32 ({model.num_probes} probes, {model.max_cg_iters} CG steps, tol "
          f"{model.cg_tol}): value-and-grad {out['value_and_grad_ms']:.2f} ms (bound "
          f"{bounds['value_and_grad'][0]:.3f} ms, {bounds['value_and_grad'][1]}; {out['launches_per_value_and_grad']} "
          f"device launches, busy {out['busy_ms']:.2f} ms); two value-and-grads bitwise equal: {out['bitwise_equal']}; "
          f"posterior() {out['posterior_ms']:.2f} ms; predict_mean per batch of {Q} median "
          f"{np.median(out['predict_mean_ms']):.3f} ms; predict_f of {SKI_CG_QUERIES} (CG) "
          f"{out['predict_f_ms']:.2f} ms; "
          f"peak {out['peak_mem_gb']:.3f} GB; launches {out['launches']}", flush=True)
    for key, ms in out["stages_ms"].items():
        if key != "cg_steps_used":
            print(f"# ski stage {key}: {ms:.3f} ms (bound {bounds[key][0]:.4f} ms, {bounds[key][1]})", flush=True)
    print(f"# ski mbcg steps used by the slowest column: {out['stages_ms']['cg_steps_used']} of {model.max_cg_iters}",
          flush=True)
    check(out["bitwise_equal"], "SKI: two identical value-and-grads differ")
    check(math.isfinite(first[0]) and np.isfinite(first[1]).all(), "non-finite SKI loss")
    mu = np.concatenate(means)
    check(mu.shape == (Q * BATCHES, 1) and np.isfinite(mu).all(), "SKI predict_mean")
    check(np.isfinite(f_mean).all() and (f_var >= 0).all(), "SKI predict_f")
    check(rel_gap(post.predict_mean(xq[0][:SKI_CG_QUERIES]), f_mean) <= 1e-5, "SKI predict_mean vs predict_f")
    check(not fit.captures(model, "Adam") and len(get_trainable(model)) == 7, "SKI capture rule or trainables")
    del model, post
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = ski_card_vs_cpu(torch)
    return out


def ski_card_vs_cpu(torch):
    """Float64 at n = 2048 with noise 0.1 and CG to SKI_CHECK_TOL (every
    column converges in under SKI_CHECK_ITERS steps, so the two routes'
    solves agree whichever step each stops on): loss, gradient and
    predict_f of 16, card against CPU, to F64_REL_TOL."""
    runs = {}
    for device in ("cuda", "cpu"):
        model, xt = ski_model(torch, SKI_CHECK_N, np.float64, device=device, noise=0.1, cg_tol=SKI_CHECK_TOL,
                              max_cg_iters=SKI_CHECK_ITERS)
        with default_dtype(torch, torch.float64):
            loss, grad = iterative_value_and_grad(torch, model)
            runs[device] = (np.array([loss]), grad, *model.predict_f(xt[:SKI_CG_QUERIES]))
    rels = [rel_gap(a, b) for a, b in zip(runs["cuda"], runs["cpu"])]
    print(f"# ski f64 card vs CPU n={SKI_CHECK_N}: max relative gaps loss {rels[0]:.3e}, gradient {rels[1]:.3e}, "
          f"predict_f mean {rels[2]:.3e}, var {rels[3]:.3e} (tol {F64_REL_TOL})", flush=True)
    check(max(rels) <= F64_REL_TOL, f"SKI card vs CPU: {rels}")
    return rels


def structured_phases(torch):
    """The state-space, Kronecker and SKI paths, each driven with the launch
    counts set to 0 just before it and read just after, and K1's shapes on
    them checked against gram_phase's cases; returns their results and the
    seconds they took together."""
    t0 = time.perf_counter()
    out = {"statespace": statespace_phase(torch), "kronecker": kronecker_phase(torch), "ski": ski_phase(torch)}
    check_gram_coverage(set().union(*(result["rbf_gram_shapes"] for result in out.values())))
    seconds = time.perf_counter() - t0
    print(f"# statespace, kronecker and ski phases: {seconds:.1f} s together", flush=True)
    return out, seconds


# -- the GP fleet, correlated outputs, the derivative GP, exact variants ------------


def f32_tol(kappa):
    """4·u·κ: the float32 unit roundoff amplified by a bound κ on the
    condition number of the factored matrix (see full_width_agreement)."""
    return 4 * F32_UNIT_ROUNDOFF * kappa


def value_and_grad_f32_vs_f64(torch, model32, model64):
    """(loss relative gap, gradient gap over its largest entry) of the same
    model in float32 and float64 (the float64 one at the float32 one's
    values)."""
    from gptorch_tpu_torch import convert
    from gptorch_tpu_torch.module import get_trainable

    convert.load_trainable(model64, {k: v.detach().double().cpu().numpy() for k, v in get_trainable(model32).items()})
    l32, g32 = iterative_value_and_grad(torch, model32)
    l64, g64 = iterative_value_and_grad(torch, model64)
    return abs(l32 - l64) / abs(l64), rel_gap(g32, g64)


def fleet_data(b, n, d, seed=0):
    """bench_ensemble.py's data: x ~ N(0, I) (b, n, d), y = sin(Σx) + 0.1ε
    (RandomState(seed)), float32."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, n, d).astype(np.float32)
    y = (np.sin(x.sum(axis=-1, keepdims=True)) + 0.1 * rng.randn(b, n, 1)).astype(np.float32)
    return x, y


def fleet_model(torch, b, n, dtype, device=None):
    """GPEnsemble on fleet_data with the Rbf-ARD template, Params in
    ``dtype`` (the float32 data cast)."""
    from gptorch_tpu_torch import kernels
    from gptorch_tpu_torch.models import GPEnsemble

    x, y = fleet_data(b, n, EN_D)
    with default_dtype(torch, torch.float64 if dtype == np.float64 else torch.float32):
        return GPEnsemble(x.astype(dtype), y.astype(dtype), kernels.Rbf(EN_D, ARD=True), device=device)


def fleet_kappa(torch, model):
    """The largest condition number over the members of K + σ²I, from each
    member's eigenvalues in float64."""
    with torch.no_grad():
        K = model._map("_compute_kyy").double()
        lam = torch.linalg.eigvalsh(K)
    return float((lam[:, -1] / lam[:, 0].clamp_min(1e-300)).max())


def timed_fit_scan(torch, model, steps, lr, what, captured):
    """A warm and a timed ``fit_scan`` Adam call of ``steps`` steps: (ms per
    step of the timed call, its losses, the replayed launches); checks the
    capture where ``captured`` says so, and that it did not happen where
    not."""
    from gptorch_tpu_torch.training import fit

    fit.fit_scan(model, "Adam", max_iter=steps, learning_rate=lr)
    check(fit.fit_scan.last_run["captured"] == captured,
          f"{what}: fit_scan {'ran eagerly' if captured else 'was captured'} on the card")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = fit.fit_scan(model, "Adam", max_iter=steps, learning_rate=lr)[1]
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / steps, [float(v) for v in losses.cpu()], replayed_launches()


def ensemble_phase(torch):
    """The fleet of GPs at bench_ensemble.py's cell; see the module
    docstring, phase 23.  Its launches are those of the fleet's own runs
    (value-and-grad, both fit_scan calls, predict_f, best()); the float64
    run, κ, one member's serial steps and member_at(3) run between them,
    outside the counts."""
    from gptorch_tpu_torch import settings
    from gptorch_tpu_torch.ops import gram

    out = {"members": EN_B, "n": EN_N, "d": EN_D, "dtype": "float32"}
    model = fleet_model(torch, EN_B, EN_N, np.float32)
    check(model.device.type == "cuda", "GPEnsemble did not land on the card")
    xq = np.random.RandomState(23).randn(Q, EN_D).astype(np.float32)
    launches = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with gram_launch_shapes() as shapes:
        with counted(launches):
            before = gram.rbf_gram.launches
            loss32, grad32 = iterative_value_and_grad(torch, model)
            out["k1_launches_per_value_and_grad"] = gram.rbf_gram.launches - before
            out["value_and_grad_ms"] = time_ms(lambda: iterative_value_and_grad(torch, model), 3)
            _, out["busy_ms"], _, out["launches_per_value_and_grad"] = device_busy_ms(
                torch, lambda: iterative_value_and_grad(torch, model))
        kappa = fleet_kappa(torch, model)
        out["f32_vs_f64"] = value_and_grad_f32_vs_f64(torch, model, fleet_model(torch, EN_B, EN_N, np.float64))
        out["f32_tol"] = f32_tol(kappa)
        with settings.override(jitter_policy="fixed"):
            with counted(launches):
                out["fixed_step_ms"], fixed_losses, r = timed_fit_scan(torch, model, EN_STEPS, EN_LR, "fleet (fixed)",
                                                                       True)
                launches.update(add_counts(launches, r))
            member = model.member_at(0)
            out["member_fixed_step_ms"], _, _ = timed_fit_scan(torch, member, EN_STEPS, EN_LR, "member (fixed)", True)
        with counted(launches):
            out["adaptive_step_ms"], adaptive_losses, _ = timed_fit_scan(torch, model, EN_STEPS, EN_LR,
                                                                         "fleet (adaptive)", False)
        out["member_adaptive_step_ms"], _, _ = timed_fit_scan(torch, member, EN_STEPS, EN_LR, "member (adaptive)",
                                                              False)
        out["losses"] = fixed_losses + adaptive_losses
        with counted(launches):
            with torch.no_grad():
                before = gram.rbf_gram.launches
                mean, var = model.predict_f(torch.as_tensor(xq, device="cuda"))
                out["k1_launches_per_predict"] = gram.rbf_gram.launches - before
                out["predict_f_ms"] = time_ms(lambda: model.predict_f(torch.as_tensor(xq, device="cuda")), 5)
            t0 = time.perf_counter()
            best, idx = model.best()
            out["best_ms"] = 1e3 * (time.perf_counter() - t0)
        fleet_loss = float(model.losses()[3].detach())
        out["member_gap"] = abs(float(model.member_at(3).loss().detach()) - fleet_loss) / abs(fleet_loss)
        out["member_tol"] = f32_tol(fleet_kappa(torch, model))
        out["launches"] = launches
    out["rbf_gram_shapes"] = shapes
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    fleet_bound = gram_bound_ms(EN_N, EN_N, EN_D, True, "float32", 4, batch=EN_B)
    print(f"# ensemble B={EN_B} n={EN_N} d={EN_D} Rbf-ARD f32: value-and-grad {out['value_and_grad_ms']:.3f} ms with "
          f"{out['k1_launches_per_value_and_grad']} K1 launch for the {EN_B} Grams (their bound "
          f"{fleet_bound[0]:.4f} ms); {out['launches_per_value_and_grad']} device launches, busy {out['busy_ms']:.3f} "
          f"ms; fit_scan Adam lr {EN_LR}: fixed jitter (captured) {out['fixed_step_ms']:.3f} ms/step, adaptive "
          f"(eager) {out['adaptive_step_ms']:.3f} ms/step; one member alone {out['member_fixed_step_ms']:.3f} / "
          f"{out['member_adaptive_step_ms']:.3f} ms/step, x {EN_B} serially {EN_B * out['member_fixed_step_ms']:.1f} / "
          f"{EN_B * out['member_adaptive_step_ms']:.1f} ms; predict_f of {Q} shared queries {out['predict_f_ms']:.3f} ms "
          f"({out['k1_launches_per_predict']} K1 launches); best() {out['best_ms']:.2f} ms (member {idx}); peak "
          f"{out['peak_mem_gb']:.3f} GB; NLML f32 vs f64 relative {out['f32_vs_f64'][0]:.3e}, gradient "
          f"{out['f32_vs_f64'][1]:.3e} (tol 4*u*kappa = {out['f32_tol']:.3e}, kappa {kappa:.3e}); member_at(3) vs "
          f"the fleet's loss after training {out['member_gap']:.3e} (tol {out['member_tol']:.3e}); launches "
          f"{out['launches']}", flush=True)
    check(out["k1_launches_per_value_and_grad"] == 1, "the fleet's value-and-grad did not build its Grams in one launch")
    check(np.isfinite(loss32) and np.isfinite(grad32).all(), "non-finite fleet loss or gradient")
    check(all(math.isfinite(v) for v in out["losses"]), "non-finite fleet training loss")
    check(fixed_losses[-1] < fixed_losses[0] and adaptive_losses[-1] < adaptive_losses[0],
          "fleet training did not lower the loss")
    check(all(r <= out["f32_tol"] for r in out["f32_vs_f64"]), f"fleet f32 vs f64: {out['f32_vs_f64']} > {out['f32_tol']}")
    check(out["member_gap"] <= out["member_tol"], f"member_at(3) against the fleet's loss: {out['member_gap']}")
    check(tuple(mean.shape) == (EN_B, Q, 1) and bool(torch.isfinite(mean).all()) and bool((var > -1e-4).all()),
          "fleet predict_f")
    check(best.X.shape == (EN_N, EN_D), "best() did not give a member")
    check(out["launches"]["rbf_gram"] > 0, "the fleet path never launched rbf_gram")
    del model, member, best
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = ensemble_card_vs_cpu(torch)
    out["jitter"] = ensemble_jitter_check(torch)
    return out


def spread_fleet(model, seed=0, scale=0.3):
    """Each member's trainable raws moved by scale·N(0, 1) draws from
    RandomState(seed), member 0 kept: the same values on any device."""
    from gptorch_tpu_torch import convert
    from gptorch_tpu_torch.module import get_trainable

    rng = np.random.RandomState(seed)
    values = {}
    for k, v in sorted(get_trainable(model).items()):
        eps = scale * rng.randn(*v.shape)
        eps[0] = 0.0
        values[k] = v.detach().double().cpu().numpy() + eps
    return convert.load_trainable(model, values)


def ensemble_card_vs_cpu(torch):
    """Float64, EN_CHECK_B members of EN_CHECK_N at spread values: the
    card's per-member losses, gradient and predict_f against the CPU's,
    and member_at(i) and the fleet's loss of member i against a standalone
    GPR of member i's data at its values on the card, all to F64_REL_TOL."""
    from gptorch_tpu_torch import convert, kernels
    from gptorch_tpu_torch.models import GPR
    from gptorch_tpu_torch.module import get_trainable

    xq = np.random.RandomState(24).randn(16, EN_D)
    runs = {}
    for device in ("cuda", "cpu"):
        model = spread_fleet(fleet_model(torch, EN_CHECK_B, EN_CHECK_N, np.float64, device=device))
        with default_dtype(torch, torch.float64):
            _, grad = iterative_value_and_grad(torch, model)
            runs[device] = (model.losses().detach().cpu().numpy(), grad, *model.predict_f(xq))
    rels = [rel_gap(a, b) for a, b in zip(runs["cuda"], runs["cpu"])]
    x, y = fleet_data(EN_CHECK_B, EN_CHECK_N, EN_D)
    member_gaps = []
    with default_dtype(torch, torch.float64):
        model = spread_fleet(fleet_model(torch, EN_CHECK_B, EN_CHECK_N, np.float64))
        losses = model.losses().detach().cpu().numpy()
        for i in range(EN_CHECK_B):
            alone = GPR(x[i].astype(np.float64), y[i].astype(np.float64), kernels.Rbf(EN_D, ARD=True), fast=False)
            shapes = {k: v.shape for k, v in get_trainable(alone).items()}
            convert.load_trainable(alone, {k: v.detach()[i].cpu().numpy().reshape(shapes[k])
                                           for k, v in get_trainable(model.member).items()})
            want = float(alone.loss().detach())
            member_gaps.append(abs(float(model.member_at(i).loss().detach()) - want) / abs(want))
            member_gaps.append(abs(losses[i] - want) / abs(want))
    print(f"# ensemble f64 B={EN_CHECK_B} n={EN_CHECK_N}: card vs CPU max relative gaps losses {rels[0]:.3e}, "
          f"gradient {rels[1]:.3e}, predict_f mean {rels[2]:.3e}, var {rels[3]:.3e}; member_at(i) and the fleet's "
          f"loss against a standalone GPR on the card {max(member_gaps):.3e} (tol {F64_REL_TOL})", flush=True)
    check(all(r <= F64_REL_TOL for r in rels + member_gaps), f"ensemble f64 checks: {rels}, {member_gaps}")
    return {"card_vs_cpu": rels, "member_vs_gpr": max(member_gaps)}


def ensemble_jitter_check(torch):
    """A float64 fleet of EN_CHECK_B members whose member 2 has its rows
    repeated and a noise of 1e-30, so its K + σ²I is singular: under the
    adaptive policy exactly that member is jittered, at the level the
    standalone adaptive cholesky picks for its matrix, and its loss in the
    fleet equals member_at(2)'s alone (F64_REL_TOL)."""
    from gptorch_tpu_torch import functions

    with default_dtype(torch, torch.float64):
        x, y = fleet_data(EN_CHECK_B, EN_CHECK_N, EN_D, seed=5)
        x[2, EN_CHECK_N // 2:] = x[2, :EN_CHECK_N // 2]
        from gptorch_tpu_torch import kernels
        from gptorch_tpu_torch.models import GPEnsemble

        model = GPEnsemble(x.astype(np.float64), y.astype(np.float64), kernels.Rbf(EN_D, ARD=True))
        p = model.member.likelihood.variance
        raw = p.raw.detach().clone()
        raw[2] = p.bijector.inverse(torch.tensor(1e-30, dtype=torch.float64, device="cuda"))
        p.set_raw(raw)
        with torch.no_grad():
            K = model._map("_compute_kyy")
            fleet = functions._select_jitter(K).cpu().numpy()
            alone = np.array([float(functions._select_jitter(K[i])) for i in range(EN_CHECK_B)])
            losses = model.losses().cpu().numpy()
            member = float(model.member_at(2).loss())
            kappa = (float(torch.linalg.eigvalsh(K[2])[-1]) + fleet[2]) / fleet[2]
    # the jittered system is conditioned ~λ_max/jitter, so the batched and the
    # single factorizations agree to a few float64 roundoffs times that
    tol = 4 * 2.0 ** -53 * kappa
    gap = abs(losses[2] - member) / abs(member)
    print(f"# ensemble adaptive jitter f64: the fleet's levels {fleet.tolist()}, each member's alone "
          f"{alone.tolist()}; member 2's loss in the fleet vs alone {gap:.3e} (tol 4*u*kappa = {tol:.3e}, kappa "
          f"{kappa:.3e})", flush=True)
    check((fleet == alone).all() and (fleet > 0).sum() == 1 and fleet[2] > 0,
          f"fleet jitter levels {fleet} against each member's {alone}")
    check(np.isfinite(losses).all() and gap <= tol, f"member 2's loss in the fleet {losses[2]} vs {member}")
    return {"levels": fleet.tolist(), "member_gap": gap, "tol": tol}


def icm_data(n, d, p, seed=0):
    """x ~ N(0, I), four smooth functions of x mixed by a seeded (p, p)
    matrix, + 0.1ε (RandomState(seed)), float32."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    f = np.stack([np.sin(x[:, 0]), np.cos(x[:, 1]), np.sin(x[:, 0] + x[:, 2]), 0.5 * x[:, 3]], axis=1)[:, :p]
    y = f @ rng.randn(p, p) + 0.1 * rng.randn(n, p)
    return x, y.astype(np.float32)


def icm_model(torch, n, dtype, device=None):
    """ICM on icm_data with Rbf-ARD, rank ICM_RANK, and κ set to
    linspace(0.5, 2, p): at the default start (κ = 1, W of rank 2 < p) B has
    a double eigenvalue at 1, where eigh's backward divides by a zero gap
    (in float32 the two eigenvalues come out equal)."""
    from gptorch_tpu_torch import kernels
    from gptorch_tpu_torch.models import ICM

    x, y = icm_data(n, D, ICM_P)
    with default_dtype(torch, torch.float64 if dtype == np.float64 else torch.float32):
        model = ICM(x.astype(dtype), y.astype(dtype), kernels.Rbf(D, ARD=True), rank=ICM_RANK, device=device)
        model.kappa = model.kappa.with_value(torch.linspace(0.5, 2.0, ICM_P))
    return model


def lmc_data(n, d, m, p, latents, seed=0):
    """bench_svgp.py's inputs and inducing inputs (sparse_data), and p
    outputs mixed by a seeded W (p, L) from L latent functions sin(x·a_l)
    + 0.1ε, float32."""
    x, _, z = sparse_data(n, d, m, np.float32, seed)
    rng = np.random.RandomState(seed + 1)
    g = np.sin(x @ rng.randn(d, latents) / math.sqrt(d))
    y = g @ rng.randn(p, latents).T + 0.1 * rng.randn(n, p)
    return x, y.astype(np.float32), z


def lmc_model(torch, n, m, dtype, batch_size=None, device=None):
    from gptorch_tpu_torch import kernels
    from gptorch_tpu_torch.models import LMC

    x, y, z = lmc_data(n, SP_D, m, ICM_P, LMC_L)
    with default_dtype(torch, torch.float64 if dtype == np.float64 else torch.float32):
        return LMC(x.astype(dtype), y.astype(dtype), kernels.Rbf(SP_D, ARD=True), num_latents=LMC_L,
                   inducing_points=z.astype(dtype), batch_size=batch_size, device=device)


def multioutput_phase(torch):
    """ICM and LMC, each its own path in the launch counts; see the module
    docstring, phase 24."""
    from gptorch_tpu_torch import settings
    from gptorch_tpu_torch.training.natgrad import make_natgrad_step

    out = {"icm": {"n": ICM_N, "d": D, "p": ICM_P, "rank": ICM_RANK},
           "lmc": {"n": SP_N, "d": SP_D, "m": SP_M, "batch": SP_BATCH, "p": ICM_P, "latents": LMC_L}}
    icm = icm_model(torch, ICM_N, np.float32)
    check(icm.device.type == "cuda", "ICM did not land on the card")
    rng = np.random.RandomState(25)
    xq = [rng.randn(Q, D).astype(np.float32) for _ in range(BATCHES)]
    o, L = out["icm"], out["lmc"]
    o["launches"], L["launches"] = {}, {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with gram_launch_shapes() as shapes:
        with counted(o["launches"]):
            loss, grad = iterative_value_and_grad(torch, icm)
            o["value_and_grad_ms"] = time_ms(lambda: iterative_value_and_grad(torch, icm), 3)
            with torch.no_grad():
                o["stages_ms"] = {"eigh x2 (K1 inside)": time_ms(icm._eigs, 3)}
            t0 = time.perf_counter()
            post = icm.posterior()
            torch.cuda.synchronize()
            o["posterior_ms"] = 1e3 * (time.perf_counter() - t0)
            o["predict_f_ms"], moments = [], []
            for xb in xq:
                t0 = time.perf_counter()
                moments.append(post.predict_f(xb))
                o["predict_f_ms"].append(1e3 * (time.perf_counter() - t0))
            t0 = time.perf_counter()
            jmean, jcov = post.predict_f_joint(xq[0][:MO_JOINT])
            o["joint_ms"] = 1e3 * (time.perf_counter() - t0)
        o["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del icm, post
        torch.cuda.empty_cache()

        lmc = lmc_model(torch, SP_N, SP_M, np.float32, batch_size=SP_BATCH)
        check(lmc.device.type == "cuda", "LMC did not land on the card")
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device="cuda").manual_seed(0)
        with counted(L["launches"]):
            with settings.override(jitter_policy="fixed"):
                lmc.fit_scan("Adam", max_iter=SP_STEPS, learning_rate=SP_LR, generator=gen)
                L["launches_per_captured_step"] = check_captured("LMC training")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses = lmc.fit_scan("Adam", max_iter=SP_STEPS, learning_rate=SP_LR, generator=gen)
                torch.cuda.synchronize()
                L["fit_scan_step_ms"] = 1e3 * (time.perf_counter() - t0) / SP_STEPS
                L["launches"].update(add_counts(L["launches"], replayed_launches()))
                L["losses"] = [float(v) for v in losses.cpu()]
            step, _ = make_natgrad_step(lmc, nat_lr=MO_NAT_LR)
            L["nat_losses"], L["nat_step_ms"] = [], []
            for _ in range(MO_NAT_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                L["nat_losses"].append(float(step(gen)))
                L["nat_step_ms"].append(1e3 * (time.perf_counter() - t0))
            t0 = time.perf_counter()
            lpost = lmc.posterior()
            torch.cuda.synchronize()
            L["posterior_ms"] = 1e3 * (time.perf_counter() - t0)
            L["predict_f_ms"], lmoments = [], []
            for xb in [np.random.RandomState(26 + i).randn(Q, SP_D).astype(np.float32) for i in range(BATCHES)]:
                t0 = time.perf_counter()
                lmoments.append(lpost.predict_f(xb))
                L["predict_f_ms"].append(1e3 * (time.perf_counter() - t0))
        L["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["rbf_gram_shapes"] = shapes
    out["peak_mem_gb"] = max(out["icm"]["peak_mem_gb"], L["peak_mem_gb"])
    print(f"# multioutput ICM n={ICM_N} d={D} p={ICM_P} rank {ICM_RANK} Rbf-ARD f32: value-and-grad "
          f"{o['value_and_grad_ms']:.2f} ms (eigh x2 with K1 {o['stages_ms']['eigh x2 (K1 inside)']:.2f} ms); "
          f"posterior() {o['posterior_ms']:.2f} ms; predict_f per batch of {Q} median {np.median(o['predict_f_ms']):.3f} "
          f"ms; predict_f_joint of {MO_JOINT} {o['joint_ms']:.2f} ms; peak {o['peak_mem_gb']:.3f} GB; launches "
          f"{o['launches']}", flush=True)
    print(f"# multioutput LMC n={SP_N} d={SP_D} m={SP_M} batch {SP_BATCH} p={ICM_P} L={LMC_L} f32: fit_scan Adam "
          f"(captured, launches recorded per captured step {L['launches_per_captured_step']}) "
          f"{L['fit_scan_step_ms']:.3f} ms/step over {SP_STEPS}; natural steps (gamma {MO_NAT_LR}) "
          f"{', '.join(f'{t:.1f}' for t in L['nat_step_ms'])} ms, losses {L['nat_losses']}; posterior() "
          f"{L['posterior_ms']:.2f} ms; predict_f per batch of {Q} median {np.median(L['predict_f_ms']):.3f} ms; peak "
          f"{L['peak_mem_gb']:.3f} GB; launches {L['launches']}", flush=True)
    check(np.isfinite(loss) and np.isfinite(grad).all(), "non-finite ICM loss or gradient")
    for mean, var in moments:
        check(mean.shape == (Q, ICM_P) and np.isfinite(mean).all() and (var >= 0).all(), "ICM predict_f")
    check(jmean.shape == (MO_JOINT, ICM_P) and jcov.shape == (MO_JOINT, ICM_P, MO_JOINT, ICM_P)
          and np.isfinite(jcov).all(), "ICM predict_f_joint")
    check(all(math.isfinite(v) for v in L["losses"] + L["nat_losses"]), "non-finite LMC loss")
    check(np.mean(L["losses"][-10:]) < np.mean(L["losses"][:10]), "LMC training did not lower the loss")
    for mean, var in lmoments:
        check(mean.shape == (Q, ICM_P) and np.isfinite(mean).all() and (var >= -1e-4).all(), "LMC predict_f")
    check(o["launches"]["rbf_gram"] > 0, "the ICM path never launched rbf_gram")
    check(L["launches"]["rbf_gram"] > 0, "the LMC path never launched rbf_gram")
    del lmc, lpost
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = multioutput_card_vs_cpu(torch)
    return out


def multioutput_card_vs_cpu(torch):
    """Float64: ICM at n = ICM_CHECK_N (loss, gradient, predict_f,
    predict_f_joint) and LMC at n = LMC_CHECK_N, m = LMC_CHECK_M (the ELBO
    and its gradient on one explicit batch, predict_f, then one natural
    step's q(u)), the card against the CPU, to F64_REL_TOL."""
    from gptorch_tpu_torch.module import get_trainable
    from gptorch_tpu_torch.training.natgrad import make_natgrad_step

    rng = np.random.RandomState(27)
    xq, xq_lmc = rng.randn(16, D), rng.randn(16, SP_D)
    runs = {}
    for device in ("cuda", "cpu"):
        with default_dtype(torch, torch.float64):
            icm = icm_model(torch, ICM_CHECK_N, np.float64, device=device)
            loss, grad = iterative_value_and_grad(torch, icm)
            lmc = lmc_model(torch, LMC_CHECK_N, LMC_CHECK_M, np.float64, device=device)
            xb, yb = lmc.X[::4], lmc.Y[::4]
            lmc.zero_grad(set_to_none=True)
            elbo = lmc._loss(xb, yb)
            elbo.backward()
            raws = get_trainable(lmc)
            lgrad = np.concatenate([raws[k].grad.cpu().numpy().ravel() for k in sorted(raws)])
            step, _ = make_natgrad_step(lmc, nat_lr=0.5, optimizer=lambda ps: torch.optim.SGD(ps, lr=0.0))
            lmc.batch_size = None  # the natural step on the full data
            step()
            q = np.concatenate([raws[k].detach().cpu().numpy().ravel() for k in ("q_mu", "q_chol")])
            lmean, lvar = lmc.predict_f(xq_lmc)  # after the step: q_mu = 0 before it gives a zero mean
            runs[device] = (np.array([loss]), grad, *icm.predict_f(xq), *icm.predict_f_joint(xq[:4]),
                            np.array([float(elbo.detach())]), lgrad, lmean, lvar, q)
    rels = [rel_gap(a, b) for a, b in zip(runs["cuda"], runs["cpu"])]
    print(f"# multioutput f64 card vs CPU: ICM n={ICM_CHECK_N} loss {rels[0]:.3e}, gradient {rels[1]:.3e}, predict_f "
          f"{rels[2]:.3e} / {rels[3]:.3e}, joint {rels[4]:.3e} / {rels[5]:.3e}; LMC n={LMC_CHECK_N} m={LMC_CHECK_M} "
          f"ELBO {rels[6]:.3e}, gradient {rels[7]:.3e}, natural step q(u) {rels[10]:.3e}, then predict_f {rels[8]:.3e} / "
          f"{rels[9]:.3e} (tol {F64_REL_TOL})", flush=True)
    check(all(r <= F64_REL_TOL for r in rels), f"multioutput f64 card vs CPU: {rels}")
    return rels


def derivative_data(n, d, seed=0):
    """x ~ N(0, I), f = sin(x·w) with a seeded w, y = f + 0.01ε and the
    exact gradient cos(x·w)·w (RandomState(seed)), float32."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d)
    w = rng.randn(d) / math.sqrt(d)
    s = x @ w
    y = np.sin(s)[:, None] + 0.01 * rng.randn(n, 1)
    return x.astype(np.float32), y.astype(np.float32), (np.cos(s)[:, None] * w[None, :]).astype(np.float32)


def derivative_model(torch, n, d, dtype, device=None):
    from gptorch_tpu_torch import kernels, likelihoods
    from gptorch_tpu_torch.models import DerivativeGPR

    x, y, g = derivative_data(n, d)
    with default_dtype(torch, torch.float64 if dtype == np.float64 else torch.float32):
        return DerivativeGPR(x.astype(dtype), y.astype(dtype), kernels.Rbf(d, ARD=True), g.astype(dtype),
                             likelihood=likelihoods.Gaussian(1e-2), grad_variance=1e-2, device=device)


def derivative_phase(torch):
    """The derivative GP; see the module docstring, phase 25."""
    out = {"n": DG_N, "d": D, "joint": DG_N * (1 + D), "dtype": "float32"}
    model = derivative_model(torch, DG_N, D, np.float32)
    check(model.device.type == "cuda", "DerivativeGPR did not land on the card")
    rng = np.random.RandomState(28)
    xq = [rng.randn(Q, D).astype(np.float32) for _ in range(2)]
    zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with gram_launch_shapes() as shapes:
        loss, grad = iterative_value_and_grad(torch, model)
        out["value_and_grad_ms"] = time_ms(lambda: iterative_value_and_grad(torch, model), 2)
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        from gptorch_tpu_torch.functions import add_diag, cholesky

        with torch.no_grad():
            A = model._joint_gram(model.X)
            noise = model._noise_diag(DG_N, D, A.dtype)
            out["stages_ms"] = {"joint Gram (K1 + derivative blocks)": time_ms(lambda: model._joint_gram(model.X), 2),
                                "factor": time_ms(lambda: cholesky(add_diag(A, noise)), 2)}
            del A
        out["predict_f_ms"] = [time_ms(lambda: model.predict_f(xq[0]), 1)]
        out["predict_grad_ms"] = [time_ms(lambda: model.predict_grad(xq[1]), 1)]
        mean, var = model.predict_f(xq[0])
        gmean, gvar = model.predict_grad(xq[1])
        out["launches"] = read_counts()
    out["rbf_gram_shapes"] = shapes
    out["peak_mem_gb"] = max(out["peak_mem_gb"], torch.cuda.max_memory_allocated() / 1e9)
    N = out["joint"]
    out["factor_bound"] = bound_ms(2 * N * N * 4, N ** 3 / 3, "float32")
    print(f"# derivative n={DG_N} d={D} (joint {N}) Rbf-ARD f32: value-and-grad {out['value_and_grad_ms']:.1f} ms; stages "
          f"{', '.join(f'{k} {v:.2f} ms' for k, v in out['stages_ms'].items())} (the factor's bound "
          f"{out['factor_bound'][0]:.2f} ms, {out['factor_bound'][1]}); predict_f per {Q} {out['predict_f_ms'][0]:.1f} "
          f"ms, predict_grad per {Q} {out['predict_grad_ms'][0]:.1f} ms (each refactors, as in the JAX package); peak "
          f"{out['peak_mem_gb']:.3f} GB; launches {out['launches']}", flush=True)
    check(np.isfinite(loss) and np.isfinite(grad).all(), "non-finite derivative GP loss or gradient")
    check(mean.shape == (Q, 1) and np.isfinite(mean).all() and (var >= -1e-3).all(), "derivative GP predict_f")
    check(gmean.shape == (Q, D) and np.isfinite(gmean).all() and (gvar >= -1e-3).all(), "derivative GP predict_grad")
    check(out["launches"]["rbf_gram"] > 0, "the derivative path never launched rbf_gram")
    del model
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = derivative_card_vs_cpu(torch)
    return out


def derivative_card_vs_cpu(torch):
    """Float64 at n = DG_CHECK_N, d = DG_CHECK_D: loss, gradient, predict_f
    and predict_grad, the card against the CPU, to F64_REL_TOL."""
    xq = np.random.RandomState(29).randn(16, DG_CHECK_D)
    runs = {}
    for device in ("cuda", "cpu"):
        model = derivative_model(torch, DG_CHECK_N, DG_CHECK_D, np.float64, device=device)
        with default_dtype(torch, torch.float64):
            loss, grad = iterative_value_and_grad(torch, model)
            runs[device] = (np.array([loss]), grad, *model.predict_f(xq), *model.predict_grad(xq))
    rels = [rel_gap(a, b) for a, b in zip(runs["cuda"], runs["cpu"])]
    print(f"# derivative f64 n={DG_CHECK_N} d={DG_CHECK_D}: card vs CPU max relative gaps loss {rels[0]:.3e}, gradient "
          f"{rels[1]:.3e}, predict_f {rels[2]:.3e} / {rels[3]:.3e}, predict_grad {rels[4]:.3e} / {rels[5]:.3e} (tol "
          f"{F64_REL_TOL})", flush=True)
    check(all(r <= F64_REL_TOL for r in rels), f"derivative f64 card vs CPU: {rels}")
    return rels


def variant_model(torch, name, n, dtype, device=None):
    """TPR (Gaussian(0.1), ν = 5), WarpedGPR (3 tanh terms) or LaplaceGP
    (Bernoulli, probit) on make_data(n, D): y for TPR, exp(y) for the
    warped GP, y > 0 for the Laplace GP; Rbf-ARD; Params in ``dtype``."""
    from gptorch_tpu_torch import kernels, likelihoods
    from gptorch_tpu_torch.models import TPR, LaplaceGP, WarpedGPR

    x, y, _ = make_data(n, D, np.float64)
    with default_dtype(torch, torch.float64 if dtype == np.float64 else torch.float32):
        k = kernels.Rbf(D, ARD=True)
        if name == "tpr":
            return TPR(x.astype(dtype), y.astype(dtype), k, likelihood=likelihoods.Gaussian(0.1), device=device)
        if name == "warped":
            return WarpedGPR(x.astype(dtype), np.exp(y).astype(dtype), k, likelihood=likelihoods.Gaussian(0.1),
                             device=device)
        return LaplaceGP(x.astype(dtype), (y > 0).astype(dtype), k, device=device)


def variant_kappa(torch, model):
    """A bound on the condition number of the matrix the model factors, in
    float64: K + σ²I (λ_max by 30 power iterations over σ²) for TPR and the
    warped GP; B = I + √W K √W ≤ 1 + max W·λ_max(K) for the Laplace GP."""
    with torch.no_grad():
        x = model.X.double()
        ell = model.kernel.length_scales.value.double()
        var = model.kernel.variance.value.double().reshape(())
        K = var * torch.exp(-0.5 * torch.cdist(x / ell, x / ell).square())
        v = torch.ones(x.shape[0], 1, dtype=torch.float64, device=x.device)
        for _ in range(30):
            v = K @ v
            lam_max = float(v.norm())
            v /= lam_max
        del K
        if hasattr(model, "num_newton"):
            _, _, _, sw, _, _ = model._laplace_state(model.X, model.Y)
            return 1.0 + float(sw.max()) ** 2 * lam_max
        noise = float(model.likelihood.variance.value)
        return (lam_max + noise) / noise


def exact_variants_phase(torch):
    """TPR, the warped GP and the Laplace GP, each its own path in the launch
    counts (the float32-against-float64 runs at half n run outside them);
    see the module docstring, phase 26."""
    from gptorch_tpu_torch.functions import cholesky

    out = {}
    rng = np.random.RandomState(30)
    xq = [rng.randn(Q, D).astype(np.float32) for _ in range(2)]
    torch.cuda.synchronize()
    with gram_launch_shapes() as shapes:
        for name, n in (("tpr", EV_N), ("warped", EV_N), ("laplace", EV_LAPLACE_N)):
            torch.cuda.reset_peak_memory_stats()
            model = variant_model(torch, name, n, np.float32)
            check(model.device.type == "cuda", f"{name} did not land on the card")
            o = out[name] = {"n": n, "d": D, "dtype": "float32", "launches": {}}
            with counted(o["launches"]):
                loss, grad = iterative_value_and_grad(torch, model)
                o["value_and_grad_ms"] = time_ms(lambda: iterative_value_and_grad(torch, model), 1)
                o["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
                with torch.no_grad():
                    o["forward_ms"] = time_ms(model.loss, 1)
                    if name != "laplace":  # K1's Gram with the noise, the adaptive probe, the blocked factor
                        kyy = model._kyy if name == "warped" else (lambda x: model.kernel.K(x, diag=model._sigma2()))
                        o["factor_ms"] = time_ms(lambda: cholesky(kyy(model.X)), 1)
                    o["predict_f_ms"] = time_ms(lambda: model.predict_f(xq[0]), 1)
                    mean, var = model.predict_f(xq[0])
                    if name == "warped":
                        o["predict_quantiles_ms"] = time_ms(lambda: model.predict_quantiles(xq[1]), 1)
                        qs = model.predict_quantiles(xq[1])
                        check(all(np.isfinite(q).all() for q in qs) and (qs[0] <= qs[1]).all()
                              and (qs[1] <= qs[2]).all(), "warped predict_quantiles")
            del model
            torch.cuda.empty_cache()
            half = variant_model(torch, name, n // 2, np.float32)
            kappa = variant_kappa(torch, half)
            half64 = variant_model(torch, name, n // 2, np.float64)
            o["f32_vs_f64"] = value_and_grad_f32_vs_f64(torch, half, half64)
            o["f32_tol"] = f32_tol(kappa)
            if name == "laplace":
                tols = (LAPLACE_F32_TOL["loss"], LAPLACE_F32_TOL["grad"])
                # the controls: the float32 run at the same values with TF32
                # products, and with its Grams in float16 and in bfloat16,
                # against float64
                l64, g64 = iterative_value_and_grad(torch, half64)
                o["controls"] = {}
                for control, context in (("tf32", tf32_allowed(torch)),
                                         ("f16_gram", rounded_rbf_grams(torch, torch.float16)),
                                         ("bf16_gram", rounded_rbf_grams(torch, torch.bfloat16)),
                                         ("biased_gram", scaled_rbf_grams(1 + 2.0 ** -11))):
                    with context:
                        lc, gc = iterative_value_and_grad(torch, half)
                    o["controls"][control] = (abs(lc - l64) / abs(l64), rel_gap(gc, g64))
            else:
                tols = (o["f32_tol"],) * 2
            del half64
            extra = f", predict_quantiles per {Q} {o['predict_quantiles_ms']:.1f} ms" if name == "warped" else ""
            stages = f" (forward {o['forward_ms']:.1f} ms" + (f", of it the Gram and the adaptive factor {o['factor_ms']:.1f} ms)"
                                                             if "factor_ms" in o else ")")
            controls = ("; controls: with TF32 products allowed {:.3e} / {:.3e}, with K1's Grams rounded to float16 "
                        "{:.3e} / {:.3e}, to bfloat16 {:.3e} / {:.3e}, scaled by 1 + 2^-11 {:.3e} / {:.3e} (the last "
                        "must fail a limit)".format(*o["controls"]["tf32"], *o["controls"]["f16_gram"],
                                                    *o["controls"]["bf16_gram"], *o["controls"]["biased_gram"])
                        if name == "laplace" else "")
            print(f"# exact variant {name} n={n} d={D} Rbf-ARD f32: value-and-grad {o['value_and_grad_ms']:.1f} ms{stages}; "
                  f"predict_f per {Q} {o['predict_f_ms']:.1f} ms (each refactors, as in the JAX package){extra}; peak "
                  f"{o['peak_mem_gb']:.3f} GB; launches {o['launches']}; at n={n // 2} loss f32 vs f64 relative "
                  f"{o['f32_vs_f64'][0]:.3e}, gradient {o['f32_vs_f64'][1]:.3e} (tol {tols[0]:.3e} / {tols[1]:.3e}; "
                  f"4*u*kappa = {o['f32_tol']:.3e}, kappa {kappa:.3e}){controls}", flush=True)
            check(np.isfinite(loss) and np.isfinite(grad).all(), f"non-finite {name} loss or gradient")
            check(mean.shape == (Q, 1) and np.isfinite(mean).all() and (var >= -1e-3).all(), f"{name} predict_f")
            check(o["f32_vs_f64"][0] <= tols[0] and o["f32_vs_f64"][1] <= tols[1],
                  f"{name} f32 vs f64: {o['f32_vs_f64']} > {tols}")
            if name == "laplace":
                gaps = o["controls"]["biased_gram"]
                check(gaps[0] > tols[0] or gaps[1] > tols[1],
                      f"the Laplace GP's float32 limits {tols} pass its Grams scaled by 1 + 2^-11 ({gaps})")
            check(o["launches"]["rbf_gram"] > 0, f"the {name} path never launched rbf_gram")
            del half
            torch.cuda.empty_cache()
    out["rbf_gram_shapes"] = shapes
    out["peak_mem_gb"] = max(out[k]["peak_mem_gb"] for k in ("tpr", "warped", "laplace"))
    out["card_vs_cpu"] = exact_variants_card_vs_cpu(torch)
    return out


def exact_variants_card_vs_cpu(torch):
    """Float64 at n = EV_CHECK_N: each variant's loss, gradient and
    predict_f (the warped GP's quantiles too), the card against the CPU,
    to F64_REL_TOL."""
    xq = np.random.RandomState(31).randn(16, D)
    rels = {}
    for name in ("tpr", "warped", "laplace"):
        runs = {}
        for device in ("cuda", "cpu"):
            model = variant_model(torch, name, EV_CHECK_N, np.float64, device=device)
            with default_dtype(torch, torch.float64):
                loss, grad = iterative_value_and_grad(torch, model)
                extra = model.predict_quantiles(xq) if name == "warped" else ()
                runs[device] = (np.array([loss]), grad, *model.predict_f(xq), *extra)
        rels[name] = [rel_gap(a, b) for a, b in zip(runs["cuda"], runs["cpu"])]
    print(f"# exact variants f64 n={EV_CHECK_N}: card vs CPU max relative gaps (loss, gradient, predict_f mean, var"
          f"[, quantiles]) {rels} (tol {F64_REL_TOL})", flush=True)
    check(all(r <= F64_REL_TOL for v in rels.values() for r in v), f"exact variants f64 card vs CPU: {rels}")
    return rels


def fleet_phases(torch):
    """The fleet, multi-output, derivative and exact-variant phases, and
    K1's shapes on them checked against gram_phase's cases; returns their
    results, the launches of each of their seven paths (counted over the
    path's own runs only), and the seconds they took together."""
    t0 = time.perf_counter()
    out = {"ensemble": ensemble_phase(torch), "multioutput": multioutput_phase(torch),
           "derivative": derivative_phase(torch), "exact_variants": exact_variants_phase(torch)}
    check_gram_coverage(set().union(*(result["rbf_gram_shapes"] for result in out.values())))
    paths = {"ensemble": out["ensemble"]["launches"],
             **{name: out["multioutput"][name]["launches"] for name in ("icm", "lmc")},
             "derivative": out["derivative"]["launches"],
             **{name: out["exact_variants"][name]["launches"] for name in ("tpr", "warped", "laplace")}}
    seconds = time.perf_counter() - t0
    print(f"# ensemble, multioutput, derivative and exact-variant phases: {seconds:.1f} s together; launches by path "
          f"{paths}", flush=True)
    return out, paths, seconds


@contextlib.contextmanager
def recorded_draws(torch, draws):
    """Inside the block, ``sampling.standard_normal`` and ``uniform`` either
    draw as usual and keep a host copy of each draw in ``draws`` (an empty
    list) or, given a recorded list, return its draws in turn on the
    caller's device and in its dtype: the CPU run records, the card's run
    replays the same numbers."""
    from gptorch_tpu_torch import sampling

    saved = sampling.standard_normal, sampling.uniform
    recording, replay = not draws, iter(list(draws))

    def wrap(fn):
        def draw(generator, shape, like):
            if not recording:
                return torch.as_tensor(next(replay), dtype=like.dtype, device=like.device)
            out = fn(generator, shape, like)
            draws.append(out.detach().cpu().numpy())
            return out

        return draw

    sampling.standard_normal, sampling.uniform = wrap(saved[0]), wrap(saved[1])
    try:
        yield
    finally:
        sampling.standard_normal, sampling.uniform = saved


def merge_counts(total, part):
    """Adds the launches ``part`` (by kernel name) to ``total``."""
    total.update(add_counts(total, part))


def batch_value_and_grad(torch, model, x, y):
    """The loss on the explicit batch (x, y) and its gradient as one float64
    vector in sorted trainable order (zeros for a trainable it does not
    read)."""
    from gptorch_tpu_torch.module import get_trainable

    model.zero_grad(set_to_none=True)
    loss = model.loss(x, y)
    loss.backward()
    raws = get_trainable(model)
    grads = [torch.zeros_like(raws[k]) if raws[k].grad is None else raws[k].grad for k in sorted(raws)]
    return float(loss.detach()), np.concatenate([g.double().cpu().numpy().ravel() for g in grads])


def trainable_values(model, spread=0.0, seed=0):
    """``model``'s raw trainables as float64 host arrays, each moved by
    ``spread``·N(0, 1) from RandomState(seed)."""
    from gptorch_tpu_torch.module import get_trainable

    rng = np.random.RandomState(seed)
    values = {k: v.detach().double().cpu().numpy() for k, v in get_trainable(model).items()}
    return {k: v + spread * rng.randn(*v.shape) for k, v in values.items()}


def het_data(n, m, seed=0):
    """The sparse cell's inputs and inducing inputs (sparse_data) with
    y = sin(x₀) + e^{g/2}·ε, g = −4 + 2·tanh(x₁) (RandomState(seed + 14)),
    float32."""
    x, _, z = sparse_data(n, SP_D, m, np.float32, seed)
    g = -4.0 + 2.0 * np.tanh(x[:, 1:2])
    y = np.sin(x[:, :1]) + np.exp(0.5 * g) * np.random.RandomState(seed + 14).randn(n, 1)
    return x, y.astype(np.float32), z


def het_model(torch, n, m, dtype, batch_size=None, device=None):
    from gptorch_tpu_torch import kernels
    from gptorch_tpu_torch.models import HeteroscedasticSVGP

    x, y, z = het_data(n, m)
    with default_dtype(torch, torch.float64 if dtype == np.float64 else torch.float32):
        return HeteroscedasticSVGP(x.astype(dtype), y.astype(dtype), kernels.Rbf(SP_D, ARD=True),
                                   inducing_points=z.astype(dtype), batch_size=batch_size, jitter=SP_JITTER,
                                   device=device)


def kuu_kappa(torch, kernel, z, jitter):
    """cond(Kuu + jitter·mean diag) from its float64 eigenvalues."""
    from gptorch_tpu_torch.models.sparse_gpr import kuu_with_jitter

    with torch.no_grad():
        eig = torch.linalg.eigvalsh(kuu_with_jitter(kernel, z, jitter).double())
    return float(eig[-1] / eig[0])


def heteroscedastic_phase(torch):
    """The heteroscedastic SVGP at the sparse cell; see the module
    docstring, phase 27.  Its launches are those of its own runs (the
    value-and-grad and its stages, both fit_scan calls, the natural steps,
    the predictions); the float32-against-float64 check runs between them."""
    from gptorch_tpu_torch import settings
    from gptorch_tpu_torch.training.natgrad import make_natgrad_step

    out = {"n": SP_N, "d": SP_D, "m": SP_M, "batch": SP_BATCH, "dtype": "float32", "launches": {}}
    rng = np.random.RandomState(32)
    xq = torch.as_tensor(rng.randn(Q, SP_D).astype(np.float32), device="cuda")
    yq = torch.as_tensor(np.sin(xq.cpu().numpy()[:, :1]) + 0.1 * rng.randn(Q, 1).astype(np.float32), device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with gram_launch_shapes() as shapes, settings.override(jitter_policy="fixed"):
        model = het_model(torch, SP_N, SP_M, np.float32, batch_size=SP_BATCH)
        check(model.device.type == "cuda", "HeteroscedasticSVGP did not land on the card")
        xb, yb = model.X[:SP_BATCH], model.Y[:SP_BATCH]
        with counted(out["launches"]):
            loss, grad = iterative_value_and_grad(torch, model)
            out["value_and_grad_ms"] = time_ms(lambda: iterative_value_and_grad(torch, model), 5)
            with torch.no_grad():
                out["stages_ms"] = {"f moments": time_ms(lambda: model._latent_f(xb), 5),
                                    "g moments": time_ms(lambda: model._latent_g(xb), 5),
                                    "ELBO (both latents, KL)": time_ms(lambda: model.log_likelihood(xb, yb), 5)}
        out["f32_vs_f64"] = het_f32_vs_f64(torch, model, xb, yb)
        with counted(out["launches"]):
            out["fit_scan_step_ms"], losses, replayed = timed_fit_scan(torch, model, SP_STEPS, SP_LR,
                                                                        "heteroscedastic", True)
        merge_counts(out["launches"], add_counts(replayed, replayed))  # the warm call's replays and the timed one's
        out["losses"] = losses
        with counted(out["launches"]):
            step, _ = make_natgrad_step(model, nat_lr=0.1)
            gen = torch.Generator(device="cuda").manual_seed(1)
            out["nat_step_ms"], out["nat_losses"] = [], []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out["nat_losses"].append(float(step(gen)))
                out["nat_step_ms"].append(1e3 * (time.perf_counter() - t0))
            with torch.no_grad():
                out["predict_y_ms"] = time_ms(lambda: model.predict_y(xq), 5)
                out["predict_log_density_ms"] = time_ms(lambda: model.predict_log_density(xq, yq), 5)
                mean, var = model.predict_y(xq)
                lpd = model.predict_log_density(xq, yq)
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["rbf_gram_shapes"] = shapes
    st = out["stages_ms"]
    bound, by = het_moments_bound_ms(SP_M, SP_BATCH, SP_D)
    out["stage_bounds_ms"] = {"f moments": bound, "g moments": bound, "ELBO (both latents, KL)": 2 * bound}
    f = out["f32_vs_f64"]
    stages = ", ".join(f"{k} {v:.3f} ms (bound {out['stage_bounds_ms'][k]:.3f}, {by})" for k, v in st.items())
    print(f"# heteroscedastic n={SP_N} d={SP_D} m={SP_M} batch {SP_BATCH} Rbf-ARD x2 f32: value-and-grad "
          f"{out['value_and_grad_ms']:.3f} ms; stages on one batch: {stages}; "
          f"fit_scan Adam (captured) {out['fit_scan_step_ms']:.3f} ms/step over {SP_STEPS}, loss {losses[0]:.1f} -> "
          f"{losses[-1]:.1f}; natural steps over both groups {', '.join(f'{t:.1f}' for t in out['nat_step_ms'])} ms; "
          f"predict_y per {Q} {out['predict_y_ms']:.3f} ms, predict_log_density per {Q} (32 nodes) "
          f"{out['predict_log_density_ms']:.3f} ms; peak {out['peak_mem_gb']:.3f} GB; launches {out['launches']}; "
          f"f32 vs f64 on one batch: loss {f['value_rel']:.3e}, gradient {f['grad_rel']:.3e} (limits {HS_F32_TOL}; "
          f"the larger latent's kappa {f['kappa']:.3e}); controls: with TF32 products allowed "
          f"{f['tf32'][0]:.3e} / {f['tf32'][1]:.3e}, with K1's Grams scaled by 1 + 2^-11 {f['biased_gram'][0]:.3e} / "
          f"{f['biased_gram'][1]:.3e} (each must fail a limit)", flush=True)
    check(np.isfinite(loss) and np.isfinite(grad).all(), "non-finite heteroscedastic loss or gradient")
    check(all(math.isfinite(v) for v in losses + out["nat_losses"]), "non-finite heteroscedastic training loss")
    check(np.mean(losses[-10:]) < np.mean(losses[:10]), "heteroscedastic training did not lower the loss")
    check(bool(torch.isfinite(mean).all() and (var > 0).all() and torch.isfinite(lpd).all()),
          "heteroscedastic predict_y / predict_log_density")
    check(f["value_rel"] <= HS_F32_TOL["loss"] and f["grad_rel"] <= HS_F32_TOL["grad"],
          f"heteroscedastic f32 vs f64: {f}")
    for control in ("tf32", "biased_gram"):
        gaps = f[control]
        check(gaps[0] > HS_F32_TOL["loss"] or gaps[1] > HS_F32_TOL["grad"],
              f"the heteroscedastic float32 limits {HS_F32_TOL} pass the {control} control ({gaps})")
    check(out["launches"]["rbf_gram"] > 0, "the heteroscedastic path never launched rbf_gram")
    del model, step
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = het_card_vs_cpu(torch)
    return out


def het_moments_bound_ms(m, b, d):
    """Least time for one latent's SVGP moments and KL on a batch of b
    (float32), in operations with a multiply-add counted as two: the factor
    of Kuu (m³/3), L⁻¹L_q (m³), L⁻¹Kuf (m²b), αᵀβ (2m²b) and the Grams'
    3d + 3 per entry; the inputs, q and the outputs each moved once."""
    ops = m ** 3 / 3 + m ** 3 + 3 * m * m * b + (m * m + m * b) * (3 * d + 3)
    return bound_ms(4 * (b * d + m * d + m + m * m + 2 * b), ops, "float32")


def het_f32_vs_f64(torch, model, xb, yb):
    """The loss and gradient on one explicit batch, float32 against the same
    model in float64 on the card at the float32 one's values, and the two
    controls of HS_F32_TOL against the same float64 run; κ, the larger
    condition number of the two latents' Kuu, is reported."""
    from gptorch_tpu_torch import convert

    model64 = het_model(torch, SP_N, SP_M, np.float64, batch_size=SP_BATCH)
    convert.load_trainable(model64, trainable_values(model))
    l32, g32 = batch_value_and_grad(torch, model, xb, yb)
    l64, g64 = batch_value_and_grad(torch, model64, xb.double(), yb.double())
    controls = {}
    for control, context in (("tf32", tf32_allowed(torch)), ("biased_gram", scaled_rbf_grams(1 + 2.0 ** -11))):
        with context:
            lc, gc = batch_value_and_grad(torch, model, xb, yb)
        controls[control] = (abs(lc - l64) / abs(l64), rel_gap(gc, g64))
    model.zero_grad(set_to_none=True)
    z = model64.Z.value.detach()
    kappa = max(kuu_kappa(torch, k, z, SP_JITTER) for k in (model64.kernel, model64.noise_kernel))
    del model64
    torch.cuda.empty_cache()
    return {"value_rel": abs(l32 - l64) / abs(l64), "grad_rel": rel_gap(g32, g64), "kappa": kappa, **controls}


def het_card_vs_cpu(torch):
    """Float64 at n = HS_CHECK_N, m = HS_CHECK_M: the loss and gradient on
    one explicit batch, predict_y and predict_log_density, one natural step
    on the full data, the card against the CPU, to F64_REL_TOL."""
    from gptorch_tpu_torch import convert
    from gptorch_tpu_torch.module import get_trainable
    from gptorch_tpu_torch.training.natgrad import make_natgrad_step

    rng = np.random.RandomState(33)
    xq, yq = rng.randn(16, SP_D), rng.randn(16, 1)
    runs, values = {}, None
    for device in ("cpu", "cuda"):
        with default_dtype(torch, torch.float64):
            model = het_model(torch, HS_CHECK_N, HS_CHECK_M, np.float64, device=device)
            values = values or trainable_values(model, spread=0.05)
            convert.load_trainable(model, values)
            b = HS_CHECK_B
            loss, grad = batch_value_and_grad(torch, model, model.X[:b], model.Y[:b])
            pred = model.predict_y(xq)
            lpd = model.predict_log_density(xq, yq)
            step, _ = make_natgrad_step(model, nat_lr=0.3, optimizer=lambda ps: torch.optim.SGD(ps, lr=0.0))
            step()
            raws = get_trainable(model)
            q = np.concatenate([raws[k].detach().cpu().numpy().ravel() for k in ("qf_mu", "qf_chol", "qg_mu",
                                                                                  "qg_chol")])
            runs[device] = (np.array([loss]), grad, *pred, lpd, q)
    rels = [rel_gap(a, b) for a, b in zip(runs["cuda"], runs["cpu"])]
    print(f"# heteroscedastic f64 n={HS_CHECK_N} m={HS_CHECK_M}: card vs CPU max relative gaps loss {rels[0]:.3e}, "
          f"gradient {rels[1]:.3e}, predict_y {rels[2]:.3e} / {rels[3]:.3e}, predict_log_density {rels[4]:.3e}, natural "
          f"step q {rels[5]:.3e} (tol {F64_REL_TOL})", flush=True)
    check(all(r <= F64_REL_TOL for r in rels), f"heteroscedastic f64 card vs CPU: {rels}")
    return rels


def deep_model(torch, n, dtype, num_samples=1, device=None):
    """The deep GP on the sparse cell's first n points: widths DGP_WIDTHS,
    DGP_M inducing points per layer (k-means), Rbf-ARD per layer."""
    from gptorch_tpu_torch.models import DeepGP

    x, y, _ = sparse_data(n, SP_D, 1, np.float32)
    with default_dtype(torch, torch.float64 if dtype == np.float64 else torch.float32):
        return DeepGP(x.astype(dtype), y.astype(dtype), widths=DGP_WIDTHS, num_inducing=DGP_M,
                      num_samples=num_samples, device=device)


def deep_phase(torch):
    """The deep GP in Salimbeni & Deisenroth's UCI setup on the sparse cell;
    see the module docstring, phase 28.  Its launches are those of its own
    runs; the launch checks count one value-and-grad each."""
    from gptorch_tpu_torch import settings

    out = {"n": SP_N, "d": SP_D, "m": DGP_M, "widths": list(DGP_WIDTHS), "dtype": "float32", "launches": {}}
    rng = np.random.RandomState(34)
    xq = [torch.as_tensor(rng.randn(Q, SP_D).astype(np.float32), device="cuda") for _ in range(2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with gram_launch_shapes() as shapes, settings.override(jitter_policy="fixed"):
        t0 = time.perf_counter()
        model = deep_model(torch, SP_N, np.float32)
        out["build_s"] = time.perf_counter() - t0
        check(model.device.type == "cuda", "DeepGP did not land on the card")
        layers = model.num_layers
        xb, yb = model.X[:DGP_BATCH], model.Y[:DGP_BATCH]
        per_call = {}
        for samples in (1, DGP_LAUNCH_SAMPLES):
            model.num_samples = samples
            c = {}
            with counted(c):
                if samples == 1:
                    loss, grad = iterative_value_and_grad(torch, model)
                else:
                    batch_value_and_grad(torch, model, xb, yb)
            per_call[samples] = c["rbf_gram"]
            merge_counts(out["launches"], c)
        model.num_samples = 1
        out["k1_launches_per_value_and_grad"] = per_call
        with counted(out["launches"]):
            out["value_and_grad_ms"] = time_ms(lambda: iterative_value_and_grad(torch, model), 3)
            out["batch_value_and_grad_ms"] = time_ms(lambda: batch_value_and_grad(torch, model, xb, yb), 3)
            out["fit_scan_step_ms"], losses, replayed = timed_fit_scan(torch, model, SP_STEPS, SP_LR, "deep GP", True)
        merge_counts(out["launches"], add_counts(replayed, replayed))
        out["losses"] = losses
        with counted(out["launches"]), torch.no_grad():
            out["predict_f_ms"] = [time_ms(lambda: model.predict_f(b), 1) for b in xq]
            mean, var = model.predict_f(xq[0])
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["rbf_gram_shapes"] = shapes
    print(f"# deep GP n={SP_N} d={SP_D} widths {DGP_WIDTHS} ({layers} layers) M={DGP_M} Rbf-ARD f32: build (k-means) "
          f"{out['build_s']:.2f} s; value-and-grad {out['value_and_grad_ms']:.2f} ms (S = 1, full data), on a batch of "
          f"{DGP_BATCH} {out['batch_value_and_grad_ms']:.2f} ms; K1 launches per value-and-grad {per_call} (by S; one "
          f"Kuu and one K(Z, F) per layer); fit_scan Adam (captured) {out['fit_scan_step_ms']:.3f} ms/step over "
          f"{SP_STEPS}, loss {losses[0]:.1f} -> {losses[-1]:.1f}; predict_f per {Q} with {DGP_PRED_SAMPLES} samples "
          f"{', '.join(f'{t:.2f}' for t in out['predict_f_ms'])} ms; peak {out['peak_mem_gb']:.3f} GB; launches "
          f"{out['launches']}", flush=True)
    check(np.isfinite(loss) and np.isfinite(grad).all(), "non-finite deep GP loss or gradient")
    check(all(v == 2 * layers for v in per_call.values()),
          f"the deep GP launched K1 {per_call} times per value-and-grad, not one Kuu and one K(Z, F) per layer")
    check(all(math.isfinite(v) for v in losses) and np.mean(losses[-10:]) < np.mean(losses[:10]),
          "deep GP training did not lower the loss")
    check(bool(torch.isfinite(mean).all() and (var >= 0).all()) and tuple(mean.shape) == (Q, 1), "deep GP predict_f")
    del model
    torch.cuda.empty_cache()
    out["gram_grad_into_f"] = deep_gram_grad_check(torch)
    out["card_vs_cpu"] = deep_card_vs_cpu(torch)
    return out


def deep_gram_grad_check(torch):
    """K1's batched cross Gram K(Z, F) of a hidden layer (Z repeated over
    DGP_LAUNCH_SAMPLES samples, F (S, n, 9)) and its gradient into F, Z,
    the length scales and the variance, against autograd through the plain
    twin on the same inputs: float64 to F64_REL_TOL, float32 against the
    float64 twin to 1e-4 of each gradient's largest entry."""
    from gptorch_tpu_torch import kernels

    gen = torch.Generator(device="cuda").manual_seed(35)
    S, n = DGP_LAUNCH_SAMPLES, 2048
    base = [torch.randn(DGP_M, SP_D, generator=gen, device="cuda", dtype=torch.float64),
            torch.randn(S, n, SP_D, generator=gen, device="cuda", dtype=torch.float64)]
    cot = torch.randn(S, DGP_M, n, generator=gen, device="cuda", dtype=torch.float64)
    grads = {}
    for name, dtype, plain in (("kernel f64", torch.float64, False), ("plain f64", torch.float64, True),
                               ("kernel f32", torch.float32, False)):
        with default_dtype(torch, dtype):
            k = kernels.Rbf(SP_D, ARD=True, length_scales=np.linspace(0.7, 1.5, SP_D), variance=1.3).to("cuda")
        z, F = (t.to(dtype).clone().requires_grad_() for t in base)
        before = read_counts()["rbf_gram"]
        if plain:
            from gptorch_tpu_torch.ops import gram

            ell = k.length_scales.value
            out = gram.rbf_gram_plain(z.expand(S, -1, -1) / ell, F / ell, k.variance.value.reshape(()))
        else:
            out = k.K(z.expand(S, -1, -1), F)
        launched = read_counts()["rbf_gram"] - before
        check(launched == (0 if plain else 1), f"K(Z, F) over {S} samples made {launched} launches")
        g = torch.autograd.grad(out, [z, F, k.length_scales.raw, k.variance.raw], cot.to(dtype))
        grads[name] = [t.double() for t in g]
    rel = {name: max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(grads[name], grads["plain f64"]))
           for name in ("kernel f64", "kernel f32")}
    print(f"# deep GP K(Z, F) batched over {S} samples ({DGP_M}, {n}) d={SP_D}, one K1 launch: gradient into Z, F, "
          f"length scales, variance against the plain twin's autograd, max relative gap f64 {rel['kernel f64']:.3e} "
          f"(tol {F64_REL_TOL}), f32 {rel['kernel f32']:.3e} (tol 1e-4)", flush=True)
    check(rel["kernel f64"] <= F64_REL_TOL and rel["kernel f32"] <= 1e-4, f"K1's gradient into F: {rel}")
    return rel


def deep_card_vs_cpu(torch):
    """Float64 at n = DGP_CHECK_N, S = 2, the trainables spread from the
    start and the normals held fixed (the CPU run's draws replayed on the
    card): the ELBO, its gradient and predict_f over DGP_PRED_SAMPLES
    passes, the card against the CPU, to F64_REL_TOL."""
    from gptorch_tpu_torch import convert

    xq = np.random.RandomState(36).randn(16, SP_D)
    runs, draws, values = {}, [], None
    for device in ("cpu", "cuda"):
        with default_dtype(torch, torch.float64), recorded_draws(torch, draws):
            model = deep_model(torch, DGP_CHECK_N, np.float64, num_samples=2, device=device)
            values = values or trainable_values(model, spread=0.05)
            convert.load_trainable(model, values)
            loss, grad = iterative_value_and_grad(torch, model)
            runs[device] = (np.array([loss]), grad, *model.predict_f(xq))
    rels = [rel_gap(a, b) for a, b in zip(runs["cuda"], runs["cpu"])]
    print(f"# deep GP f64 n={DGP_CHECK_N} S=2 (draws held): card vs CPU max relative gaps ELBO {rels[0]:.3e}, gradient "
          f"{rels[1]:.3e}, predict_f {rels[2]:.3e} / {rels[3]:.3e} (tol {F64_REL_TOL})", flush=True)
    check(all(r <= F64_REL_TOL for r in rels), f"deep GP f64 card vs CPU: {rels}")
    return rels


def stream_model(torch, dtype, device=None, z=None):
    """StreamingVFE at the sparse cell's inducing inputs with the fixed
    hyperparameters of ST_NOISE's note, Params in ``dtype``."""
    from gptorch_tpu_torch import ekernels, likelihoods
    from gptorch_tpu_torch.models import StreamingVFE

    with default_dtype(torch, torch.float64 if dtype == np.float64 else torch.float32):
        kernel = ekernels.Rbf(SP_D, ARD=True, length_scales=np.linspace(0.8, 1.6, SP_D))
        return StreamingVFE(kernel, z.astype(dtype), likelihood=likelihoods.Gaussian(ST_NOISE), jitter=SP_JITTER,
                            device=device)


def stream_batches(torch, x, y, dtype):
    """The cell's data on the card in ``dtype``, cut into batches of
    SP_BATCH (the last one shorter)."""
    xs = torch.as_tensor(x.astype(dtype), device="cuda")
    ys = torch.as_tensor(y.astype(dtype), device="cuda")
    return [(xs[lo : lo + SP_BATCH], ys[lo : lo + SP_BATCH]) for lo in range(0, xs.shape[0], SP_BATCH)]


def stream_run(torch, dtype, x, y, z, xq, context=contextlib.nullcontext):
    """Streams every batch through ``update`` (no autograd) inside
    ``context()``: (the model, its bound, predict_f at xq).  The model is
    built first (building one pins TF32 off)."""
    with torch.no_grad():
        s = stream_model(torch, dtype, z=z)
        with context():
            for xb, yb in stream_batches(torch, x, y, dtype):
                s = s.update(xb, yb)
        q = torch.as_tensor(xq.astype(dtype), device="cuda")
        return s, float(s.log_likelihood()), [t.double().cpu().numpy() for t in s.predict_f(q)]


def streaming_phase(torch):
    """StreamingVFE and OnlineSGPR at the sparse cell; see the module
    docstring, phase 29.  Each model's launches are those of its own runs;
    the checks run between them."""
    from gptorch_tpu_torch import settings

    x, y, z = sparse_data(SP_N, SP_D, SP_M, np.float32)
    rng = np.random.RandomState(37)
    xq = rng.randn(Q, SP_D).astype(np.float32)
    o = {"n": SP_N, "d": SP_D, "m": SP_M, "batch": SP_BATCH, "dtype": "float32", "launches": {}}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with gram_launch_shapes() as shapes, settings.override(jitter_policy="fixed"), torch.no_grad():
        s = stream_model(torch, np.float32, z=z)
        check(s.device.type == "cuda", "StreamingVFE did not land on the card")
        batches = stream_batches(torch, x, y, np.float32)
        full = [b for b in batches if b[0].shape[0] == SP_BATCH]
        q = torch.as_tensor(xq, device="cuda")
        with counted(o["launches"]):
            ms = []
            for xb, yb in batches:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                s = s.update(xb, yb)
                end.record()
                end.synchronize()
                ms.append(start.elapsed_time(end))
                if len(ms) == len(full):
                    s_full = s
            o["update_ms"] = ms
            o["log_likelihood_ms"] = time_ms(s.log_likelihood, 5)
            bound = float(s.log_likelihood().detach())
            o["predict_f_ms"] = time_ms(lambda: s.predict_f(q), 5)
            o["predict_uncertain_ms"] = time_ms(lambda: s.predict_uncertain(q, torch.full_like(q, 0.01)), 3)
            mean, var = s.predict_uncertain(q, torch.full_like(q, 0.01))
            o["downdate_ms"] = time_ms(lambda: s.downdate(*batches[-1]), 5)
            back = s.downdate(*batches[-1])
        # the 11 full batches as one captured CUDA graph of 11 updates
        xs_full = torch.stack([b[0] for b in full])
        ys_full = torch.stack([b[1] for b in full])
        s0 = stream_model(torch, np.float32, z=z)

        def stream():
            out = s0
            for i in range(len(full)):
                out = out.update(xs_full[i], ys_full[i])
            return out

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            stream()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        c = {}
        with counted(c):
            with torch.cuda.graph(graph):
                s_cap = stream()
        graph.replay()
        torch.cuda.synchronize()
        gap = max(float(((getattr(s_cap, k) - getattr(s_full, k)).abs().max()) / getattr(s_full, k).abs().max())
                  for k in ("phi_w", "r_w", "yy", "kdiag_sum", "n_seen"))
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            graph.replay()
        end.record()
        end.synchronize()
        o["captured_stream_ms"] = start.elapsed_time(end) / 3
        o["launches_per_replay"] = c
        merge_counts(o["launches"], add_counts(c, c, c, c))  # one replay to check, three timed
        del graph
    o["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    o["captured_vs_eager"] = gap
    o["checks"] = stream_checks(torch, x, y, z, xq, bound)
    f = o["checks"]
    print(f"# streaming StreamingVFE n={SP_N} d={SP_D} m={SP_M} batches of {SP_BATCH} f32: update per batch (ms) "
          f"{[round(v, 3) for v in ms]}, median {float(np.median(ms)):.3f}; captured stream of {len(full)} batches "
          f"{o['captured_stream_ms']:.3f} ms ({o['captured_stream_ms'] / len(full):.3f} ms a batch; launches recorded "
          f"per replay {c}; replayed statistics vs eager {gap:.3e}); log_likelihood {o['log_likelihood_ms']:.3f} ms; "
          f"predict_f per {Q} {o['predict_f_ms']:.3f} ms; predict_uncertain per {Q} {o['predict_uncertain_ms']:.3f} ms; "
          f"downdate {o['downdate_ms']:.3f} ms; peak {o['peak_mem_gb']:.3f} GB; launches {o['launches']}; f64 stream "
          f"vs batch VFE on the card: bound {f['f64_bound_rel']:.3e}, predict_f {f['f64_mean_rel']:.3e} / "
          f"{f['f64_var_rel']:.3e} (tol {F64_REL_TOL}); f32 vs f64: bound {f['f32_bound_rel']:.3e}, predict_f "
          f"{f['f32_mean_rel']:.3e} / {f['f32_var_rel']:.3e} (limits {ST_F32_TOL}); the control with TF32 products: "
          f"bound {f['tf32_bound_rel']:.3e}, predict_f {f['tf32_mean_rel']:.3e} / {f['tf32_var_rel']:.3e} (must fail a "
          f"limit)", flush=True)
    check(all(math.isfinite(v) for v in (bound, float(back.log_likelihood().detach()))), "non-finite streamed bound")
    check(bool(torch.isfinite(mean).all() and (var >= 0).all()), "StreamingVFE predict_uncertain")
    check(gap <= 1e-6, f"the captured stream's statistics differ from the eager ones: {gap}")
    check(c["rbf_gram"] == 2 * len(full), f"a captured update recorded {c} launches, not Kuu and Kuf")
    check(o["launches"]["rbf_gram"] > 0, "the streaming path never launched rbf_gram")
    out = {"streaming_vfe": o}
    del s, s_full, s_cap, s0, back, batches, full, xs_full, ys_full
    torch.cuda.empty_cache()
    out["online_sgpr"] = online_phase(torch, x, y, z, xq)
    out["rbf_gram_shapes"] = shapes | out["online_sgpr"].pop("rbf_gram_shapes")
    out["peak_mem_gb"] = max(o["peak_mem_gb"], out["online_sgpr"]["peak_mem_gb"])
    return out


# float32 against float64 StreamingVFE at the cell's n under the fixed
# jitter policy (the bound relative; the predict_f mean and variance over
# their largest entries): an H100 reads 1.3e-7, 1.8e-6 and 8.5e-6 (the
# whitened statistics keep B = I + βΦ̃ well conditioned; the bound's β·yy −
# β²‖c‖² cancels only to these digits at n = 45730); the limits keep a
# factor of about 20.  Its control: the float32 stream with TF32 products
# allowed must fail one (it reads 1.3e-6, 3.5e-4 and 8.5e-6: the means).
ST_F32_TOL = {"bound": 4e-6, "mean": 4e-5, "var": 2e-4}


def stream_checks(torch, x, y, z, xq, bound32):
    """Float64 on the card: the streamed bound and predict_f against the
    port's batch VFE on all the data, to F64_REL_TOL; float32 against that
    float64 stream within ST_F32_TOL, and the float32 stream with TF32
    products allowed (the control that must fail a limit); under the fixed
    jitter policy, as the phase streams."""

    from gptorch_tpu_torch import settings

    with settings.override(jitter_policy="fixed"):
        return _stream_checks(torch, x, y, z, xq, bound32)


def _stream_checks(torch, x, y, z, xq, bound32):
    from gptorch_tpu_torch import likelihoods
    from gptorch_tpu_torch.models import VFE

    s64, b64, (m64, v64) = stream_run(torch, np.float64, x, y, z, xq)
    with default_dtype(torch, torch.float64), torch.no_grad():
        vfe = VFE(x.astype(np.float64), y.astype(np.float64), s64.kernel, inducing_points=z.astype(np.float64),
                  likelihood=likelihoods.Gaussian(ST_NOISE), jitter=SP_JITTER, device="cuda")
        vb = float(vfe.log_likelihood())
        vm, vv = (t.cpu().numpy() for t in vfe.predict_f(torch.as_tensor(xq.astype(np.float64), device="cuda")))
    del vfe
    _, _, (m32, v32) = stream_run(torch, np.float32, x, y, z, xq)
    _, bt, (mt, vt) = stream_run(torch, np.float32, x, y, z, xq, lambda: tf32_allowed(torch))
    out = {"f64_bound_rel": abs(b64 - vb) / abs(vb), "f64_mean_rel": rel_gap(m64, vm), "f64_var_rel": rel_gap(v64, vv),
           "f32_bound_rel": abs(bound32 - b64) / abs(b64), "f32_mean_rel": rel_gap(m32, m64),
           "f32_var_rel": rel_gap(v32, v64), "tf32_bound_rel": abs(bt - b64) / abs(b64), "tf32_mean_rel": rel_gap(mt, m64),
           "tf32_var_rel": rel_gap(vt, v64)}
    torch.cuda.empty_cache()
    check(max(out["f64_bound_rel"], out["f64_mean_rel"], out["f64_var_rel"]) <= F64_REL_TOL,
          f"f64 StreamingVFE vs batch VFE: {out}")
    check(out["f32_bound_rel"] <= ST_F32_TOL["bound"] and out["f32_mean_rel"] <= ST_F32_TOL["mean"]
          and out["f32_var_rel"] <= ST_F32_TOL["var"], f"f32 StreamingVFE vs f64: {out}")
    check(out["tf32_bound_rel"] > ST_F32_TOL["bound"] or out["tf32_mean_rel"] > ST_F32_TOL["mean"]
          or out["tf32_var_rel"] > ST_F32_TOL["var"], f"the StreamingVFE float32 limits pass TF32 products: {out}")
    return out


def online_model(torch, dtype, z, jitter=SP_JITTER, device="cuda"):
    """OnlineSGPR at the cell's inducing inputs (trainable), Rbf-ARD,
    Gaussian(0.1), Params in ``dtype``."""
    from gptorch_tpu_torch import kernels, likelihoods
    from gptorch_tpu_torch.models import OnlineSGPR

    with default_dtype(torch, torch.float64 if dtype == np.float64 else torch.float32):
        return OnlineSGPR(kernels.Rbf(SP_D, ARD=True), z.astype(dtype), likelihood=likelihoods.Gaussian(0.1),
                          jitter=jitter, device=device)


def online_steps(torch, x, y, z, xq):
    """ON_BATCHES steps of ON_ITERS Adam iterations in float64 under the
    "none" jitter policy: (the model, ms per call, the launches its
    captured graphs replayed, predict_f at xq).  A call replays the graph
    it captured or, where it captured none, the last one (the same batch
    size and has_old)."""
    from gptorch_tpu_torch import settings
    from gptorch_tpu_torch.training import fit

    model = online_model(torch, np.float64, z)
    ms, replayed, used, seen = [], {}, None, set()
    with settings.override(jitter_policy="none"):
        for i in range(ON_BATCHES):
            lo = i * SP_BATCH
            xb, yb = x[lo : lo + SP_BATCH].astype(np.float64), y[lo : lo + SP_BATCH].astype(np.float64)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.step(xb, yb, fit_iters=ON_ITERS, learning_rate=ON_LR)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            check(fit.captures(model, "Adam"), "OnlineSGPR.step did not capture under the none policy")
            new = [g for g in fit._GRAPHS.get(model, {}).values() if id(g) not in seen]
            seen.update(id(g) for g in new)
            used = new[-1] if new else used
            merge_counts(replayed, {k: v * ON_ITERS for k, v in used.launches_per_step.items()})
        mean, var = model.predict_f(xq.astype(np.float64))
    return model, ms, replayed, (mean, var)


def online_float32_fails(torch, x, y, z):
    """The same steps as online_steps in float32: the index of the first
    batch whose step raised FloatingPointError (a non-finite loss) or left
    a non-finite summary, or None where all stayed finite."""
    from gptorch_tpu_torch import settings
    from gptorch_tpu_torch.training import fit

    model = online_model(torch, np.float32, z)
    failed = None
    with settings.override(jitter_policy="none"):
        for i in range(ON_BATCHES):
            lo = i * SP_BATCH
            try:
                model.step(x[lo : lo + SP_BATCH], y[lo : lo + SP_BATCH], fit_iters=ON_ITERS, learning_rate=ON_LR)
            except FloatingPointError:
                failed = i
                break
            if not bool(torch.isfinite(model.L_D).all() and torch.isfinite(model.r_a).all()):
                failed = i
                break
    fit.release_graphs(model)
    del model
    torch.cuda.empty_cache()
    return failed


def online_phase(torch, x, y, z, xq):
    """OnlineSGPR: ON_BATCHES captured steps in float64, the same steps in
    float32 (which must go non-finite), then the exactness anchor; see the
    module docstring, phase 29."""
    from gptorch_tpu_torch.training import fit

    o = {"m": SP_M, "batch": SP_BATCH, "iters": ON_ITERS, "launches": {}, "dtype": "float64"}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with gram_launch_shapes() as shapes:
        with counted(o["launches"]):
            model, ms, replayed, (mean, var) = online_steps(torch, x, y, z, xq)
        o["step_ms"] = ms
        graphs = len(fit._GRAPHS.get(model, {}))
        per_step = {}
        for steps in fit._GRAPHS.get(model, {}).values():
            merge_counts(per_step, steps.launches_per_step)
        o["launches_per_captured_step"] = per_step  # summed over the two graphs
        merge_counts(o["launches"], replayed)
        q = torch.as_tensor(xq.astype(np.float64), device="cuda")
        with torch.no_grad(), counted(o["launches"]):
            o["predict_f_ms"] = time_ms(lambda: model.predict_f(q), 5)
        o["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del model
        torch.cuda.empty_cache()
        o["float32_failed_at_batch"] = online_float32_fails(torch, x, y, z)
    o["rbf_gram_shapes"] = shapes
    o["anchor"] = online_anchor(torch, x, y, z, xq)
    a = o["anchor"]
    print(f"# streaming OnlineSGPR m={SP_M} batches of {SP_BATCH}, {ON_ITERS} Adam iterations a step (lr {ON_LR}), "
          f"{o['dtype']} (float32 non-finite from batch {o['float32_failed_at_batch']}): step ms {[round(v, 1) for v in ms]} "
          f"({', '.join(f'{v / ON_ITERS:.3f}' for v in ms)} ms an iteration); captured graphs on the model {graphs}; "
          f"launches recorded per captured step (both graphs) {per_step}; predict_f per {Q} {o['predict_f_ms']:.3f} ms; peak "
          f"{o['peak_mem_gb']:.3f} GB; launches {o['launches']}; anchor (f64, theta and Z fixed, {a['batches']} "
          f"batches): summed bounds vs batch VFE {a['bound_rel']:.3e}, predict_f {a['mean_rel']:.3e} / "
          f"{a['var_rel']:.3e} (limits {ON_ANCHOR_TOL})", flush=True)
    check(bool(np.isfinite(mean).all() and np.isfinite(var).all()), "OnlineSGPR gave non-finite predictions")
    check(o["float32_failed_at_batch"] is not None,
          "OnlineSGPR stayed finite in float32 at the cell: ROADMAP §3 and this phase's dtype are out of date")
    check(graphs == 2, f"OnlineSGPR.step kept {graphs} captured graphs, not one per has_old")
    check(o["launches"]["rbf_gram"] > 0, "the online path never launched rbf_gram")
    return o


# OnlineSGPR's exactness anchor in float64 (the summed bounds relative;
# predict_f over the largest entries): the relative floors 1e-10 on V_aa −
# S_a and S_a set the gap, which an H100 reads as 3.7e-9, 5.4e-9 and
# 1.3e-10; the limits keep a factor of about 20.
ON_ANCHOR_TOL = {"bound": 1e-7, "mean": 1e-7, "var": 3e-9}


def online_anchor(torch, x, y, z, xq):
    """θ and Z fixed over the whole stream, float64, the "none" policy: the
    per-step bounds summed and predict_f against batch VFE on all the data,
    within ON_ANCHOR_TOL (JAX tests/test_online.py:41-87)."""
    from gptorch_tpu_torch import likelihoods, settings
    from gptorch_tpu_torch.models import VFE

    with settings.override(jitter_policy="none"), torch.no_grad():
        model = online_model(torch, np.float64, z, jitter=ON_ANCHOR_JITTER)
        total, batches = 0.0, 0
        for lo in range(0, SP_N, SP_BATCH):
            model._set_batch(x[lo : lo + SP_BATCH].astype(np.float64), y[lo : lo + SP_BATCH].astype(np.float64))
            total += float(model.log_likelihood())
            model._absorb()
            batches += 1
        q = torch.as_tensor(xq.astype(np.float64), device="cuda")
        mo, vo = (t.cpu().numpy() for t in model.predict_f(q))
        with default_dtype(torch, torch.float64):
            vfe = VFE(x.astype(np.float64), y.astype(np.float64), model.kernel, inducing_points=z.astype(np.float64),
                      likelihood=likelihoods.Gaussian(0.1), jitter=ON_ANCHOR_JITTER, device="cuda")
        vb = float(vfe.log_likelihood())
        vm, vv = (t.cpu().numpy() for t in vfe.predict_f(q))
    out = {"batches": batches, "bound_rel": abs(total - vb) / abs(vb), "mean_rel": rel_gap(mo, vm),
           "var_rel": rel_gap(vo, vv)}
    del model, vfe
    torch.cuda.empty_cache()
    check(out["bound_rel"] <= ON_ANCHOR_TOL["bound"] and out["mean_rel"] <= ON_ANCHOR_TOL["mean"]
          and out["var_rel"] <= ON_ANCHOR_TOL["var"], f"OnlineSGPR anchor vs batch VFE: {out}")
    return out


def pathwise_moments(samples, mean, var, prior_var, what):
    """The draws' mean and variance at each query against predict_f's, in
    standard errors of S draws (sd/√S for the mean, σ²·√(2/(S − 1)) for
    the variance) plus, for the variance, the random-feature prior's own
    error, √(2/F) of the prior variance ``prior_var`` (F = PW_FEATURES);
    each within 5."""
    s = samples.shape[0]
    m_se = np.abs(samples.mean(0) - mean) / np.sqrt(var / s)
    v_se = np.abs(samples.var(0, ddof=1) - var) / (var * math.sqrt(2.0 / (s - 1))
                                                   + prior_var * math.sqrt(2.0 / PW_FEATURES))
    out = {"mean_max_se": float(m_se.max()), "var_max_se": float(v_se.max())}
    check(np.isfinite(samples).all() and out["mean_max_se"] <= 5 and out["var_max_se"] <= 5,
          f"{what}: the samples' moments disagree with predict_f: {out}")
    return out


def timed_pathwise(torch, sampler, model, cand, samples, what):
    """One warm and one timed call of ``sampler`` (a fresh generator each),
    (ms of the timed call, its samples)."""
    sampler(model, cand, samples, PW_FEATURES, generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sampler(model, cand, samples, PW_FEATURES, generator=torch.Generator(device="cuda").manual_seed(1))
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    check(tuple(out.shape) == (samples, cand.shape[0], 1) and bool(torch.isfinite(out).all()), f"{what} samples")
    return ms, out


def pathwise_iterative_phase(torch, model):
    """pathwise_gpr_samples on phase 15's matrix-free model (n = 100000):
    PW_IT_SAMPLES paths over PATH_CANDIDATES candidates, K̂⁻¹ by the
    posterior's CG (K3) and K(x*, X) by K1; the moments at IT_CG_QUERIES
    candidates against the CG-exact predict_f.  A path of its own in the
    launch counts."""
    from gptorch_tpu_torch import sampling

    out = {"n": IT_N, "samples": PW_IT_SAMPLES, "features": PW_FEATURES, "candidates": PATH_CANDIDATES,
           "launches": {}}
    cand = torch.as_tensor(np.random.RandomState(38).randn(PATH_CANDIDATES, D).astype(np.float32), device="cuda")
    with gram_launch_shapes() as shapes, counted(out["launches"]), torch.no_grad():
        out["ms"], samples = timed_pathwise(torch, sampling.pathwise_gpr_samples, model, cand, PW_IT_SAMPLES,
                                            "iterative pathwise")
    with torch.no_grad():
        mean, var = model.posterior().predict_f(cand[:IT_CG_QUERIES])
    out["rbf_gram_shapes"] = shapes
    out["moments"] = pathwise_moments(samples[:, :IT_CG_QUERIES].cpu().numpy(), mean.cpu().numpy(),
                                      var.cpu().numpy(), float(model.kernel.variance.value.detach()), "iterative pathwise")
    print(f"# pathwise iterative GPR n={IT_N} d={D}: {PW_IT_SAMPLES} paths of {PW_FEATURES} features over "
          f"{PATH_CANDIDATES} candidates {out['ms']:.1f} ms ({out['ms'] / PW_IT_SAMPLES:.1f} ms a sample; the "
          f"posterior's CG alpha, the CG solve of the {PW_IT_SAMPLES} prior residuals, K(x*, X)); moments at "
          f"{IT_CG_QUERIES} candidates {out['moments']}; launches {out['launches']}", flush=True)
    check(out["launches"]["gram_mvm"] > 0 and out["launches"]["rbf_gram"] > 0,
          f"the iterative pathwise sampler did not launch gram_mvm and rbf_gram: {out['launches']}")
    del samples
    torch.cuda.empty_cache()
    return out


def pathwise_phase(torch):
    """pathwise_gpr_samples on the exact serving model and
    pathwise_svgp_samples on the sparse cell's SVGP; see the module
    docstring, phase 30.  Each sampler a path of its own."""
    from gptorch_tpu_torch import kernels, likelihoods, sampling, settings
    from gptorch_tpu_torch.models import GPR, SVGP

    out = {"gpr": {"n": N, "d": D, "launches": {}}, "svgp": {"n": SP_N, "d": SP_D, "m": SP_M, "launches": {}}}
    rng = np.random.RandomState(39)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with gram_launch_shapes() as shapes, settings.override(jitter_policy="fixed"):
        x, y, _ = make_data(N, D, np.float32)
        gpr = GPR(x, y, kernels.Rbf(D, ARD=True), likelihood=likelihoods.Gaussian(0.1), device="cuda")
        xs, ys, z = sparse_data(SP_N, SP_D, SP_M, np.float32)
        svgp = SVGP(xs, ys, kernels.Rbf(SP_D, ARD=True), inducing_points=z, batch_size=SP_BATCH, jitter=SP_JITTER,
                    device="cuda")
        for name, model, sampler, d in (("gpr", gpr, sampling.pathwise_gpr_samples, D),
                                        ("svgp", svgp, sampling.pathwise_svgp_samples, SP_D)):
            o = out[name]
            cand = torch.as_tensor(rng.randn(PATH_CANDIDATES, d).astype(np.float32), device="cuda")
            with counted(o["launches"]), torch.no_grad():
                o["ms"], samples = timed_pathwise(torch, sampler, model, cand, PW_SAMPLES, f"pathwise {name}")
            with torch.no_grad():
                mean, var = (model.posterior() if name == "gpr" else model).predict_f(cand[:Q])
            o["moments"] = pathwise_moments(samples[:, :Q].cpu().numpy(), mean.cpu().numpy(), var.cpu().numpy(),
                                            float(model.kernel.variance.value.detach()), f"pathwise {name}")
            check(o["launches"]["rbf_gram"] > 0, f"the pathwise {name} path never launched rbf_gram")
            del samples
        del gpr, svgp
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    out["rbf_gram_shapes"] = shapes
    g, s = out["gpr"], out["svgp"]
    print(f"# pathwise {PW_SAMPLES} paths of {PW_FEATURES} features over {PATH_CANDIDATES} candidates f32: exact GPR "
          f"n={N} d={D} {g['ms']:.1f} ms ({g['ms'] / PW_SAMPLES:.2f} ms a sample; posterior() included), moments "
          f"{g['moments']}, launches {g['launches']}; SVGP n={SP_N} m={SP_M} {s['ms']:.2f} ms ({s['ms'] / PW_SAMPLES:.3f} "
          f"ms a sample), moments {s['moments']}, launches {s['launches']}; peak {out['peak_mem_gb']:.3f} GB",
          flush=True)
    out["card_vs_cpu"] = pathwise_card_vs_cpu(torch)
    return out


def pathwise_card_vs_cpu(torch):
    """Float64 at n = PW_CHECK_N, the draws held fixed (the CPU run's draws
    replayed on the card): pathwise_gpr_samples with the dense and the
    iterative solver (CG to IT_CHECK_TOL) and pathwise_svgp_samples, the
    card against the CPU, to F64_REL_TOL."""
    from gptorch_tpu_torch import kernels, likelihoods, sampling
    from gptorch_tpu_torch.models import GPR, SVGP

    x, y, _ = make_data(PW_CHECK_N, D, np.float64)
    xs, ys, z = sparse_data(PW_CHECK_N, SP_D, 64, np.float64)
    rng = np.random.RandomState(40)
    cand, cand_sp = rng.randn(64, D), rng.randn(64, SP_D)
    makers = {
        "gpr dense": lambda dev: (GPR(x, y, kernels.Rbf(D, ARD=True), likelihood=likelihoods.Gaussian(0.1),
                                      device=dev), sampling.pathwise_gpr_samples, cand),
        "gpr iterative": lambda dev: (GPR(x, y, kernels.Rbf(D, ARD=True), likelihood=likelihoods.Gaussian(0.1),
                                          solver="iterative", probes=4, max_cg_iters=IT_CHECK_ITERS, precond_rank=32,
                                          cg_tol=IT_CHECK_TOL, device=dev), sampling.pathwise_gpr_samples, cand),
        "svgp": lambda dev: (SVGP(xs, ys, kernels.Rbf(SP_D, ARD=True), inducing_points=z, jitter=SP_JITTER,
                                  device=dev), sampling.pathwise_svgp_samples, cand_sp),
    }
    rels = {}
    for name, make in makers.items():
        runs, draws = {}, []
        for device in ("cpu", "cuda"):
            with default_dtype(torch, torch.float64), recorded_draws(torch, draws):
                model, sampler, c = make(device)
                runs[device] = sampler(model, c, 4, 256, generator=torch.Generator(device=device))
        rels[name] = rel_gap(runs["cuda"], runs["cpu"])
    print(f"# pathwise f64 n={PW_CHECK_N} (draws held): card vs CPU max relative gaps {rels} (tol {F64_REL_TOL})",
          flush=True)
    check(all(r <= F64_REL_TOL for r in rels.values()), f"pathwise f64 card vs CPU: {rels}")
    return rels


def sparse_variant_phases(torch, it_pathwise):
    """The heteroscedastic, deep, streaming and pathwise phases, and K1's
    shapes on them (and on the iterative pathwise sampler, ``it_pathwise``,
    run in phase 15) checked against gram_phase's cases; returns their
    results, the launches of each of their seven paths (counted over the
    path's own runs only), and the seconds they took together."""
    t0 = time.perf_counter()
    out = {"heteroscedastic": heteroscedastic_phase(torch), "deep": deep_phase(torch),
           "streaming": streaming_phase(torch), "pathwise": pathwise_phase(torch)}
    check_gram_coverage(set().union(it_pathwise["rbf_gram_shapes"],
                                    *(result["rbf_gram_shapes"] for result in out.values())))
    paths = {"heteroscedastic": out["heteroscedastic"]["launches"], "deep": out["deep"]["launches"],
             "streaming_vfe": out["streaming"]["streaming_vfe"]["launches"],
             "online_sgpr": out["streaming"]["online_sgpr"]["launches"],
             "pathwise_gpr": out["pathwise"]["gpr"]["launches"], "pathwise_svgp": out["pathwise"]["svgp"]["launches"],
             "pathwise_iterative": it_pathwise["launches"]}
    seconds = time.perf_counter() - t0
    print(f"# heteroscedastic, deep, streaming and pathwise phases: {seconds:.1f} s together; launches by path "
          f"{paths}", flush=True)
    return out, paths, seconds


@contextlib.contextmanager
def held_gram_launches(torch):
    """Holds the first K1 launch of each shape made inside the block, where
    gram_phase's cases do not cover it, against the twin on the same inputs
    (outside a graph capture; the warm step before a capture is held): yields
    {(n1, n2, symmetric, d, batch, dtype): max |kernel − twin| / var as a
    device tensor}, read by check_held_grams.  Every shape launched is also
    added to ``shapes`` of gram_launch_shapes, for check_gram_coverage."""
    from gptorch_tpu_torch.ops import gram

    covered = {(n1, n2, sym, d, None) for _, n1, n2, sym, d, _ in GRAM_CASES}
    covered |= {(n1, n2, sym, d, b) for _, b, n1, n2, sym, d, _ in GRAM_BATCHED_CASES}
    held, launch = {}, gram._launch

    def holding(x1, x2, var, diag):
        out = launch(x1, x2, var, diag)
        n2 = x1.shape[-2] if x2 is None else x2.shape[-2]
        batch = x1.shape[0] if x1.ndim == 3 else None
        key = (x1.shape[-2], n2, x2 is None, x1.shape[-1], batch, dtype_name(x1.dtype))
        if key[:5] not in covered and key not in held and not torch.cuda.is_current_stream_capturing():
            with torch.no_grad():
                plain = gram.rbf_gram_plain(x1, x2, var, diag)
                scale = var if var.ndim == 0 else var[:, None, None]
                held[key] = ((out - plain).abs() / scale).amax()
        return out

    gram._launch = holding
    try:
        yield held
    finally:
        gram._launch = launch


def check_held_grams(held, what):
    """Fails unless every K1 launch held by held_gram_launches agrees with
    the twin to gram_phase's limit (TOL·1.3 per unit of var)."""
    errors = {key: float(err) for key, err in held.items()}
    worst = {name: max((e for k, e in errors.items() if k[5] == name), default=0.0) for name in TOL}
    print(f"# {what}: {len(errors)} K1 shapes held against the twin as they launched (n grows, or a small float64 "
          f"check); worst max|kernel-plain|/var {worst} (tol {TOL['float32'] * 1.3:.1e} / {TOL['float64'] * 1.3:.1e})",
          flush=True)
    for key, err in errors.items():
        check(err <= TOL[key[5]] * 1.3, f"{what}: rbf_gram at {key} error {err} against the twin")
    return {"shapes": len(errors), "worst": worst}


@contextlib.contextmanager
def new_path_grams(torch):
    """gram_launch_shapes and held_gram_launches together: yields (shapes,
    held), and check_gram_coverage then sees the shapes that were not
    held."""
    with gram_launch_shapes() as shapes, held_gram_launches(torch) as held:
        yield shapes, held


def unheld_shapes(shapes, held):
    return {s for s in shapes if s not in held}


def timed_reading(torch, out, name, fn):
    """Runs ``fn`` once, synchronised on both sides, inside a counted block:
    records under out["readings"][name] its host-wall ms, its K1 launches
    and the peak device memory of the call; adds the launches to
    out["launches"].  Returns fn's result."""
    launches = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with counted(launches):
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
    merge_counts(out["launches"], launches)
    out.setdefault("readings", {})[name] = {"ms": ms, "rbf_gram": launches["rbf_gram"],
                                             "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    return result


def in_box(x, bounds):
    x = np.atleast_2d(np.asarray(x))
    return bool(np.all(x >= bounds[:, 0]) and np.all(x <= bounds[:, 1]))


def box_candidates(torch, generator, n, bounds, like):
    """bayesopt's candidate draw: ``n`` uniform points in the box from
    ``generator`` (sampling.uniform, as suggest draws them)."""
    from gptorch_tpu_torch import sampling

    lo, hi = (torch.as_tensor(bounds[:, i], dtype=like.dtype, device=like.device) for i in (0, 1))
    return lo[None] + sampling.uniform(generator, (n, bounds.shape[0]), lo) * (hi - lo)[None]


def bayesopt_phase(torch):
    """bayesopt at the serving cell; see the module docstring, phase 31.
    Returns its results and the float32 posterior, which the design phase
    uses."""
    from gptorch_tpu_torch import bayesopt, kernels, likelihoods, settings
    from gptorch_tpu_torch.models import GPR

    out = {"n": N, "d": D, "launches": {}, "readings": {}}
    bounds = np.array([[-BO_BOX, BO_BOX]] * D)
    x, y, _ = make_data(N, D, np.float32)
    with new_path_grams(torch) as (shapes, held), settings.override(jitter_policy="fixed"):
        model = GPR(x, y, kernels.Rbf(D, ARD=True), likelihood=likelihoods.Gaussian(0.1))
        post = timed_reading(torch, out, "posterior()", model.posterior)
        cached = bayesopt._CachedPosterior(post, model.Y)
        best = torch.min(model.Y)
        gen = torch.Generator(device="cuda").manual_seed(31)
        cand = box_candidates(torch, gen, BO_CANDIDATES, bounds, post.X)
        with torch.no_grad():
            for name in sorted(bayesopt.ACQUISITIONS):
                bayesopt.score_candidates(post, cand, best, name)  # warm
                timed_reading(torch, out, f"score {name}", lambda: bayesopt.score_candidates(post, cand, best, name))
            out["score_ms_cuda_events"] = time_ms(lambda: bayesopt.score_candidates(post, cand, best, "ei"), 5)
        state = gen.get_state()
        suggest = lambda: bayesopt.suggest(cached, bounds, n_candidates=BO_CANDIDATES, refine_steps=BO_STEPS,
                                           generator=gen)
        suggest()  # warm, from the same candidates
        gen.set_state(state)
        xs = timed_reading(torch, out, "suggest", suggest)
        # the point is the refined one only where its EI is at least the best
        # candidate's; else it is that candidate
        gen.set_state(state)
        cand = box_candidates(torch, gen, BO_CANDIDATES, bounds, post.X)
        with torch.no_grad():
            scores = bayesopt.score_candidates(post, cand, best, "ei")
            best_cand = cand[torch.argmax(scores)].cpu().numpy()
            ei_x = float(bayesopt.score_candidates(post, torch.as_tensor(xs[None], device="cuda"), best, "ei")[0])
        out["ei_suggestion"], out["ei_best_candidate"] = ei_x, float(scores.max())
        out["refined"] = ei_x >= out["ei_best_candidate"]
        check(out["refined"] or np.array_equal(xs, best_cand),
              f"bayesopt: suggest returned a point whose EI {ei_x} is below the best candidate's "
              f"{out['ei_best_candidate']} and that is not that candidate")
        out["thompson"] = timed_reading(torch, out, "suggest_thompson", lambda: bayesopt.suggest_thompson(
            cached, bounds, q=BO_TS_Q, n_candidates=BO_CANDIDATES, num_features=BO_FEATURES, generator=gen))
        out["qei"] = timed_reading(torch, out, "suggest_qei", lambda: bayesopt.suggest_qei(
            cached, bounds, q=BO_QEI_Q, n_samples=BO_QEI_SAMPLES, n_candidates=BO_QEI_CANDIDATES,
            num_features=BO_FEATURES, refine_steps=BO_QEI_STEPS, generator=gen))

        def believer():
            picks, p, yn = [], post, model.Y
            for _ in range(BO_BELIEVER):
                xb = bayesopt.suggest(bayesopt._CachedPosterior(p, yn), bounds, n_candidates=BO_CANDIDATES,
                                      refine_steps=BO_STEPS, generator=gen)
                mu, _ = p.predict_f(xb[None])
                p = p.condition_on(xb[None], mu)
                yn = torch.cat([yn, torch.as_tensor(mu, device="cuda")])
                picks.append(xb)
            return np.stack(picks)

        out["believer"] = timed_reading(torch, out, f"believer x{BO_BELIEVER}", believer)
        for name, pts in (("suggest", xs), ("thompson", out["thompson"]), ("qei", out["qei"]),
                          ("believer", out["believer"])):
            check(np.isfinite(pts).all() and in_box(pts, bounds), f"bayesopt: {name} left the box: {pts}")
        check(len(np.unique(np.round(out["believer"], 5), axis=0)) == BO_BELIEVER,
              "bayesopt: believer picks repeat a point")
        out["f32_vs_f64_ei"] = bo_f32_vs_f64(torch, x, y, post, cand, scores)
    check(out["launches"]["rbf_gram"] > 0, "bayesopt never launched rbf_gram")
    out["held"] = check_held_grams(held, "bayesopt")
    out["rbf_gram_shapes"] = unheld_shapes(shapes, held)
    out["peak_mem_gb"] = max(r["peak_gb"] for r in out["readings"].values())
    out["card_vs_cpu"] = bo_card_vs_cpu(torch)
    r = out["readings"]
    print(f"# bayesopt n={N} d={D} f32 over [-{BO_BOX}, {BO_BOX}]^{D}: posterior() {r['posterior()']['ms']:.1f} ms; "
          f"score_candidates over {BO_CANDIDATES} "
          + ", ".join(f"{k[6:]} {v['ms']:.2f} ms" for k, v in r.items() if k.startswith("score "))
          + f" (ei {out['score_ms_cuda_events']:.3f} ms by CUDA events); suggest ({BO_CANDIDATES} candidates, "
          f"{BO_STEPS} steps) {r['suggest']['ms']:.1f} ms, {r['suggest']['rbf_gram']} K1 launches, refined "
          f"{out['refined']} (EI {ei_x:.4e} vs best candidate {out['ei_best_candidate']:.4e}); suggest_thompson "
          f"q={BO_TS_Q} {r['suggest_thompson']['ms']:.1f} ms; suggest_qei q={BO_QEI_Q} ({BO_QEI_SAMPLES} paths, "
          f"{BO_QEI_CANDIDATES} candidates, {BO_QEI_STEPS} steps) {r['suggest_qei']['ms']:.1f} ms; {BO_BELIEVER} "
          f"believer picks {r[f'believer x{BO_BELIEVER}']['ms']:.1f} ms; peak {out['peak_mem_gb']:.2f} GB; launches "
          f"{out['launches']}", flush=True)
    print(f"# bayesopt readings: {json.dumps({k: {kk: round(vv, 4) for kk, vv in v.items()} for k, v in r.items()})}",
          flush=True)
    return out, post


def bo_f32_vs_f64(torch, x, y, post32, cand32, scores32):
    """EI over the candidates from the float64 posterior of the same model
    against the float32 one's, absolute (y's units)."""
    from gptorch_tpu_torch import bayesopt, kernels, likelihoods
    from gptorch_tpu_torch.models import GPR

    with default_dtype(torch, torch.float64), torch.no_grad():
        model = GPR(x.astype(np.float64), y.astype(np.float64), kernels.Rbf(D, ARD=True),
                    likelihood=likelihoods.Gaussian(0.1))
        post = model.posterior()
        s64 = bayesopt.score_candidates(post, cand32.double(), torch.min(model.Y), "ei")
        gap = float((scores32.double() - s64).abs().max())
        del model, post
    torch.cuda.empty_cache()
    print(f"# bayesopt EI over {BO_CANDIDATES} candidates, float32 vs float64 posterior: max abs {gap:.3e} (largest EI "
          f"{float(s64.max()):.3e}; tol {SERVING_TOL})", flush=True)
    check(gap <= SERVING_TOL, f"bayesopt: float32 EI off float64 by {gap}")
    return gap


def bo_card_vs_cpu(torch):
    """suggest, suggest_thompson and suggest_qei in float64 at BO_CHECK_N,
    the card against the CPU with the CPU's draws replayed: the same points
    to F64_REL_TOL (absolute, in the box's units)."""
    from gptorch_tpu_torch import bayesopt, kernels, likelihoods
    from gptorch_tpu_torch.models import GPR

    x, y, _ = make_data(BO_CHECK_N, D, np.float64)
    bounds = np.array([[-BO_BOX, BO_BOX]] * D)
    calls = {
        "suggest": lambda m, g: bayesopt.suggest(m, bounds, n_candidates=BO_CANDIDATES, refine_steps=BO_STEPS,
                                                 generator=g),
        "thompson": lambda m, g: bayesopt.suggest_thompson(m, bounds, q=BO_TS_Q, n_candidates=1024, num_features=256,
                                                           refine_steps=10, generator=g),
        "qei": lambda m, g: bayesopt.suggest_qei(m, bounds, q=2, n_samples=16, n_candidates=512, num_features=256,
                                                 refine_steps=10, generator=g),
    }
    gaps = {}
    for name, call in calls.items():
        runs, draws = {}, []
        for device in ("cpu", "cuda"):
            with default_dtype(torch, torch.float64), recorded_draws(torch, draws):
                model = GPR(x, y, kernels.Rbf(D, ARD=True), likelihood=likelihoods.Gaussian(0.1), device=device)
                runs[device] = call(model, torch.Generator(device=device))
        gaps[name] = float(np.abs(runs["cuda"] - runs["cpu"]).max())
    print(f"# bayesopt f64 n={BO_CHECK_N} (draws held): card vs CPU max abs point gaps {gaps} (tol {F64_REL_TOL})",
          flush=True)
    check(all(g <= F64_REL_TOL for g in gaps.values()), f"bayesopt f64 card vs CPU: {gaps}")
    return gaps


def levy(u):
    """The Levy function (minimum 0 at x = 1) of x = −10 + 20u, u in [0, 1]^d."""
    x = -10.0 + 20.0 * np.asarray(u, dtype=float)
    w = 1.0 + (x - 1.0) / 4.0
    return float(np.sin(np.pi * w[0]) ** 2 + np.sum((w[:-1] - 1) ** 2 * (1 + 10 * np.sin(np.pi * w[:-1] + 1) ** 2))
                 + (w[-1] - 1) ** 2 * (1 + np.sin(2 * np.pi * w[-1]) ** 2))


@contextlib.contextmanager
def capture_seconds(torch):
    """Seconds spent making each captured fit_scan step inside the block
    (fit._CapturedSteps: the warm step and the capture)."""
    from gptorch_tpu_torch.training import fit

    spent, init = [], fit._CapturedSteps.__init__

    def timed(self, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        init(self, *args, **kwargs)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)

    fit._CapturedSteps.__init__ = timed
    try:
        yield spent
    finally:
        fit._CapturedSteps.__init__ = init


def bayesopt_loop_phase(torch):
    """BayesOpt's suggest/observe loop; see the module docstring, phase 32."""
    from gptorch_tpu_torch import bayesopt, kernels, settings

    out = {"n0": LOOP_N0, "d": D, "launches": {}, "iterations": []}
    bounds = np.array([[0.0, 1.0]] * D)
    rng = np.random.RandomState(32)
    x0 = rng.rand(LOOP_N0, D)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with new_path_grams(torch) as (shapes, held), default_dtype(torch, torch.float64), \
            settings.override(jitter_policy="none"):
        bo = bayesopt.BayesOpt(bounds=bounds, kernel=lambda: kernels.Rbf(D, ARD=True), fit_iters=LOOP_FIT_ITERS,
                               refit_every=LOOP_REFIT, n_candidates=BO_CANDIDATES, seed=32)
        check(bo.device.type == "cuda", "BayesOpt did not land on the card")
        for u in x0:
            bo.observe(u, levy(u))
        best, fantasy_gap = [bo.best_y], None
        for _ in range(LOOP_ITERS):
            it = {"refit": bo._post is None}
            launches = {}
            with counted(launches):
                if it["refit"]:
                    with capture_seconds(torch) as cap:
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        bo._fit()
                        torch.cuda.synchronize()
                        it["fit_ms"] = 1e3 * (time.perf_counter() - t0)
                    it["capture_ms"] = 1e3 * sum(cap)
                    check_captured("bayesopt_loop: a refit")
                    merge_counts(launches, replayed_launches())
                t0 = time.perf_counter()
                xs = bo.suggest()
                torch.cuda.synchronize()
                it["suggest_ms"] = 1e3 * (time.perf_counter() - t0)
                check(in_box(xs, bounds), f"bayesopt_loop: suggestion out of the box: {xs}")
                t0 = time.perf_counter()
                bo.observe(xs, levy(xs))
                torch.cuda.synchronize()
                it["observe_ms"] = 1e3 * (time.perf_counter() - t0)
            it["rbf_gram"] = launches["rbf_gram"]
            merge_counts(out["launches"], launches)
            out["iterations"].append(it)
            best.append(bo.best_y)
            if fantasy_gap is None and bo._post is not None and len(bo.Y) - bo._n_fit == LOOP_REFIT - 1:
                fantasy_gap = loop_fantasy_gap(bo)
        check(all(b1 <= b0 for b0, b1 in zip(best, best[1:])), f"bayesopt_loop: best_y rose: {best}")
        check(fantasy_gap is not None and fantasy_gap <= LOOP_FANTASY_TOL,
              f"bayesopt_loop: fantasy posterior off a fresh factorization by {fantasy_gap}")
        out["batches"] = {}
        for strategy in ("ts", "believer", "qei"):
            refit = bo._post is None
            batch = timed_reading(torch, out, f"suggest_batch {strategy}", lambda: bo.suggest_batch(LOOP_BATCH, strategy))
            if refit:
                check_captured("bayesopt_loop: a refit")
                merge_counts(out["launches"], replayed_launches())
            check(batch.shape == (LOOP_BATCH, D) and in_box(batch, bounds), f"bayesopt_loop: bad {strategy} batch")
            out["batches"][strategy] = batch
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["matern"] = loop_matern(torch, bayesopt, bounds, x0)
    check(out["launches"]["rbf_gram"] > 0, "the bayesopt loop never launched rbf_gram")
    out["held"] = check_held_grams(held, "bayesopt_loop")
    out["rbf_gram_shapes"] = unheld_shapes(shapes, held)
    out["best_y"], out["fantasy_gap"] = best, fantasy_gap
    refits = [it for it in out["iterations"] if it["refit"]]
    fantasies = [it for it in out["iterations"] if not it["refit"]]
    total = lambda it: it.get("fit_ms", 0.0) + it["suggest_ms"] + it["observe_ms"]
    out["refit_ms"] = float(np.median([total(it) for it in refits]))
    out["fantasy_ms"] = float(np.median([total(it) for it in fantasies]))
    out["capture_share"] = float(np.median([it["capture_ms"] / it["fit_ms"] for it in refits]))
    r = out["readings"]
    print(f"# bayesopt_loop Levy d={D} f64, {LOOP_N0} observations then {LOOP_ITERS} iterations (Rbf-ARD, "
          f"{LOOP_FIT_ITERS} captured Adam steps a refit, refit every {LOOP_REFIT}): median ms an iteration: refit "
          f"{out['refit_ms']:.1f} (fit {np.median([it['fit_ms'] for it in refits]):.1f}, of it capture "
          f"{100 * out['capture_share']:.0f} %), fantasy {out['fantasy_ms']:.1f} (suggest "
          f"{np.median([it['suggest_ms'] for it in fantasies]):.1f}, observe/condition_on "
          f"{np.median([it['observe_ms'] for it in fantasies]):.2f}); K1 launches an iteration "
          f"{[it['rbf_gram'] for it in out['iterations']]}; best_y {best[0]:.4f} -> {best[-1]:.4f}; fantasy vs fresh "
          f"posterior {fantasy_gap:.2e} (tol {LOOP_FANTASY_TOL}); suggest_batch({LOOP_BATCH}) "
          + ", ".join(f"{k[14:]} {v['ms']:.1f} ms" for k, v in r.items())
          + f"; peak {out['peak_mem_gb']:.3f} GB; launches {out['launches']}; Matern52 default {out['matern']}",
          flush=True)
    return out


def loop_fantasy_gap(bo):
    """The loop's fantasy posterior against a fresh posterior() of a GPR on
    all the observations at the refit's hyperparameters, predict_f at 64
    points of the box: max abs gap over the largest moment."""
    import copy

    from gptorch_tpu_torch.models import GPR

    mu, sd = bo._y_shift
    yn = (np.asarray(bo.Y)[:, None] - mu) / sd
    fresh = GPR(np.asarray(bo.X), yn, copy.deepcopy(bo._model.kernel), likelihood=copy.deepcopy(bo._model.likelihood),
                fast=False, device=bo.device).posterior()
    xq = np.random.RandomState(33).rand(64, D)
    got, want = bo._post.predict_f(xq), fresh.predict_f(xq)
    return max(float(np.abs(a - b).max()) / float(np.abs(b).max()) for a, b in zip(got, want))


def loop_matern(torch, bayesopt, bounds, x0):
    """LOOP_MATERN_ITERS iterations with the default kernel (Matern52, no
    K1): ms an iteration and the K1 launches, which must be none."""
    bo = bayesopt.BayesOpt(bounds=bounds, fit_iters=LOOP_FIT_ITERS, refit_every=LOOP_REFIT,
                           n_candidates=BO_CANDIDATES, seed=34)
    for u in x0:
        bo.observe(u, levy(u))
    launches, ms = {}, []
    with counted(launches):
        for _ in range(LOOP_MATERN_ITERS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            xs = bo.suggest()
            bo.observe(xs, levy(xs))
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            check(in_box(xs, bounds), "bayesopt_loop Matern52: suggestion out of the box")
    check(launches["rbf_gram"] == 0, f"the Matern52 loop launched rbf_gram: {launches}")
    return {"ms": [round(m, 1) for m in ms], "rbf_gram": launches["rbf_gram"], "best_y": bo.best_y}


def design_phase(torch, post):
    """design on phase 31's posterior; see the module docstring, phase 33."""
    from gptorch_tpu_torch import design
    from gptorch_tpu_torch.functions import trtrs

    out = {"n": N, "q": DE_Q, "candidates": BO_CANDIDATES, "references": DE_REF, "launches": {}, "readings": {}}
    bounds = np.array([[-BO_BOX, BO_BOX]] * D)
    gen = torch.Generator(device="cuda").manual_seed(33)
    cand = box_candidates(torch, gen, BO_CANDIDATES, bounds, post.X)
    ref = box_candidates(torch, gen, DE_REF, bounds, post.X)
    with new_path_grams(torch) as (shapes, held):
        picks = {}
        for strategy in ("alc", "variance"):
            kw = {"x_ref": ref} if strategy == "alc" else {}
            picks[strategy] = timed_reading(torch, out, strategy, lambda: design.suggest_batch(
                post, cand, q=DE_Q, strategy=strategy, **kw)[0])
        with torch.no_grad():
            kxc = post.kernel.K(post.X, cand)
            out["stages_ms"] = {"K(X, x_cand)": time_ms(lambda: post.kernel.K(post.X, cand), 5),
                                "L⁻¹K(X, x_cand)": time_ms(lambda: trtrs(kxc, post.L), 3)}
            del kxc
        out["alc_identity"] = alc_identity(torch, post, cand, ref, picks["alc"][0])
    for strategy, idx in picks.items():
        check(len(set(idx.tolist())) == DE_Q, f"design: {strategy} picked a candidate twice: {idx}")
    check(out["launches"]["rbf_gram"] > 0, "design never launched rbf_gram")
    out["held"] = check_held_grams(held, "design")
    out["rbf_gram_shapes"] = unheld_shapes(shapes, held)
    out["peak_mem_gb"] = max(r["peak_gb"] for r in out["readings"].values())
    out["alc_f64"] = alc_identity_f64(torch)
    n, c, itemsize = N, BO_CANDIDATES, 4
    bounds_ms = {"K(X, x_cand)": gram_bound_ms(n, c, D, False, "float32", itemsize)[0],
                 "L⁻¹K(X, x_cand)": bound_ms((n * (n + 1) // 2 + 2 * n * c) * itemsize, n * n * c, "float32")[0]}
    out["stage_bounds_ms"] = bounds_ms
    r = out["readings"]
    print(f"# design n={N} f32, {BO_CANDIDATES} candidates, {DE_REF} references, q={DE_Q}: alc {r['alc']['ms']:.1f} ms "
          f"({r['alc']['ms'] / DE_Q:.1f} ms a pick), variance {r['variance']['ms']:.1f} ms "
          f"({r['variance']['ms'] / DE_Q:.1f} ms a pick); stages "
          + ", ".join(f"{k} {v:.2f} ms (bound {bounds_ms[k]:.2f})" for k, v in out["stages_ms"].items())
          + f"; peak {out['peak_mem_gb']:.2f} GB (each pick's condition_on makes an (n + 1)² factor); picks "
          f"{ {k: v.tolist() for k, v in picks.items()} }; launches {out['launches']}", flush=True)
    return out


def alc_identity(torch, post, cand, ref, idx):
    """The first pick's ALC against the variance drop over the references
    that condition_on realizes, relative, in float32; and the same with the
    candidate-reference Gram scaled by 1 + 2^-11, the control that must fail
    DE_F32_TOL."""
    from gptorch_tpu_torch import design

    with torch.no_grad():
        xq = cand[idx : idx + 1]
        _, var0 = post.predict_f(ref)
        mu, _ = post.predict_f(xq)
        cond = post.condition_on(xq, mu)
        _, var1 = cond.predict_f(ref)
        realized = float(torch.sum(var0[:, 0].double() - var1[:, 0].double()))
        del cond
        alc = float(design.alc_acquisition(post, xq, ref)[0])
        with scaled_rbf_grams(1.0 + 2.0 ** -11):
            control = float(design.alc_acquisition(post, xq, ref)[0])
    torch.cuda.empty_cache()
    gap, control_gap = abs(alc - realized) / abs(realized), abs(control - realized) / abs(realized)
    print(f"# design ALC identity f32 n={N}: ALC {alc:.6e}, realized drop {realized:.6e}, relative gap {gap:.3e} (tol "
          f"{DE_F32_TOL:.0e}); control (Grams x (1 + 2^-11)) {control_gap:.3e}", flush=True)
    check(gap <= DE_F32_TOL, f"design: the first pick's ALC is off its realized drop by {gap}")
    check(control_gap > DE_F32_TOL, f"design: the control passed the ALC limit ({control_gap})")
    return {"alc": alc, "realized": realized, "gap": gap, "control_gap": control_gap}


def alc_identity_f64(torch):
    """The ALC identity in float64 on the card at DE_F64_N (make_data):
    DE_F64_TOL relative."""
    from gptorch_tpu_torch import design, kernels, likelihoods
    from gptorch_tpu_torch.models import GPR

    x, y, _ = make_data(DE_F64_N, D, np.float64)
    with default_dtype(torch, torch.float64), torch.no_grad():
        post = GPR(x, y, kernels.Rbf(D, ARD=True), likelihood=likelihoods.Gaussian(0.1)).posterior()
        rng = np.random.RandomState(35)
        cand = torch.as_tensor(rng.uniform(-BO_BOX, BO_BOX, (64, D)), device="cuda")
        ref = torch.as_tensor(rng.uniform(-BO_BOX, BO_BOX, (256, D)), device="cuda")
        idx, cond = design.suggest_batch(post, cand, q=1, strategy="alc", x_ref=ref)
        realized = float(torch.sum(post.predict_f(ref)[1][:, 0] - cond.predict_f(ref)[1][:, 0]))
        alc = float(design.alc_acquisition(post, cand[idx], ref)[0])
    gap = abs(alc - realized) / abs(realized)
    print(f"# design ALC identity f64 n={DE_F64_N}: relative gap {gap:.3e} (tol {DE_F64_TOL:.0e})", flush=True)
    check(gap <= DE_F64_TOL, f"design: float64 ALC off its realized drop by {gap}")
    return gap


def metrics_phase(torch, serving_post):
    """metrics: kfold_cv and summarize; see the module docstring, phase 34."""
    from gptorch_tpu_torch import kernels, likelihoods, metrics, settings

    out = {"k": CV_K, "n": CV_N, "iters": CV_ITERS, "launches": {}, "readings": {}}
    x, y, _ = make_data(CV_N, D, np.float32, seed=34)
    with new_path_grams(torch) as (shapes, held), settings.override(jitter_policy="fixed"):
        with capture_seconds(torch) as cap:
            res = timed_reading(torch, out, "kfold_cv", lambda: metrics.kfold_cv(
                x, y, lambda: kernels.Rbf(D, ARD=True), k=CV_K, likelihood_factory=lambda: likelihoods.Gaussian(0.1),
                fit_iters=CV_ITERS, learning_rate=CV_LR, device="cuda"))
        per_step = check_captured("metrics: the fold fleet")
        merge_counts(out["launches"], replayed_launches())
        out["capture_ms"] = 1e3 * sum(cap)
        check(per_step.get("rbf_gram") == 1, f"metrics: the fleet's step launched K1 {per_step} times, not once")
        ens = res["ensemble"]
        # the fleet's steps alone: a second run replays the captured graph
        timed_reading(torch, out, "fit replay", lambda: ens.fit("Adam", max_iter=CV_ITERS, learning_rate=CV_LR,
                                                                 scan=True))
        check_captured("metrics: the fleet's second fit")
        merge_counts(out["launches"], replayed_launches())
        out["fit_ms_per_iter"] = out["readings"]["fit replay"]["ms"] / CV_ITERS
        del ens, res["ensemble"]
        torch.cuda.empty_cache()
        rng = np.random.RandomState(36)
        batches = make_data(N, D, np.float32)[2]
        with counted(out["launches"]):
            preds = [serving_post.predict_y(xb) for xb in batches]
        xq = np.concatenate(batches)
        yq = np.sin(xq[:, :1]) + 0.1 * rng.randn(xq.shape[0], 1)
        out["summary"] = metrics.summarize(yq, np.concatenate([p[0] for p in preds]),
                                           np.concatenate([p[1] for p in preds]))
    for key in ("fold_rmse", "fold_nlpd"):
        check(np.isfinite(res[key]).all() and res[key].shape == (CV_K,), f"metrics: bad {key} {res[key]}")
    check(all(np.isfinite(v) for v in out["summary"].values()), f"metrics: non-finite summary {out['summary']}")
    check(out["launches"]["rbf_gram"] > 0, "metrics never launched rbf_gram")
    out["held"] = check_held_grams(held, "metrics")
    out["rbf_gram_shapes"] = unheld_shapes(shapes, held)
    out["cv"] = {k: (v.tolist() if isinstance(v, np.ndarray) else v) for k, v in res.items()}
    out["peak_mem_gb"] = max(r["peak_gb"] for r in out["readings"].values())
    out["card_vs_cpu"] = cv_card_vs_cpu(torch)
    r = out["readings"]
    print(f"# metrics kfold_cv k={CV_K} n={CV_N} d={D} f32 ({CV_ITERS} captured Adam steps, one batched K1 launch of "
          f"{CV_K} x {CV_N - CV_N // CV_K}^2 a step): {r['kfold_cv']['ms']:.1f} ms in all (capture "
          f"{out['capture_ms']:.1f} ms), the steps alone {out['fit_ms_per_iter']:.3f} ms an iteration; fold rmse "
          f"{np.round(res['fold_rmse'], 4).tolist()}, nlpd {np.round(res['fold_nlpd'], 4).tolist()}; summarize over "
          f"{Q * BATCHES} serving queries {out['summary']}; peak {out['peak_mem_gb']:.3f} GB; launches "
          f"{out['launches']}", flush=True)
    return out


def cv_card_vs_cpu(torch):
    """kfold_cv in float64 at CV_CHECK_K folds of CV_CHECK_N rows, the card
    against the CPU: fold RMSE and NLPD to F64_REL_TOL relative."""
    from gptorch_tpu_torch import kernels, metrics

    x, y, _ = make_data(CV_CHECK_N, D, np.float64, seed=37)
    runs = {}
    for device in ("cpu", "cuda"):
        with default_dtype(torch, torch.float64):
            runs[device] = metrics.kfold_cv(x, y, lambda: kernels.Rbf(D, ARD=True), k=CV_CHECK_K,
                                            fit_iters=CV_CHECK_ITERS, device=device)
    gaps = {key: rel_gap(runs["cuda"][key], runs["cpu"][key]) for key in ("fold_rmse", "fold_nlpd")}
    print(f"# metrics kfold_cv f64 k={CV_CHECK_K} n={CV_CHECK_N}: card vs CPU max relative gaps {gaps} (tol "
          f"{F64_REL_TOL})", flush=True)
    check(all(g <= F64_REL_TOL for g in gaps.values()), f"metrics f64 card vs CPU: {gaps}")
    return gaps


def ksearch_data(n, dtype):
    """bench_ksearch.py's data: x ~ U(0, 12) sorted, y = x/2 + cos 3x + 0.1ε
    (RandomState(1))."""
    rng = np.random.RandomState(1)
    x = np.sort(rng.uniform(0, 12, n))[:, None].astype(dtype)
    return x, (0.5 * x + np.cos(3.0 * x) + 0.1 * rng.randn(n, 1)).astype(dtype)


@contextlib.contextmanager
def lbfgs_evaluations():
    """The L-BFGS evaluations and iterations of every fit_scan call inside
    the block, summed.  Inside it fit_scan is the wrapper, so fit records
    each run on the wrapper's ``last_run``."""
    from gptorch_tpu_torch.training import fit

    total, fit_scan = [0, 0], fit.fit_scan

    def counting(*args, **kwargs):
        result = fit_scan(*args, **kwargs)
        total[0] += int(np.sum(fit.fit_scan.last_run["evaluations"] or 0))
        total[1] += fit.fit_scan.last_run["steps"]
        return result

    counting.last_run = None
    fit.fit_scan = counting
    try:
        yield total
    finally:
        fit.fit_scan = fit_scan


def structure_phase(torch):
    """kernel_search at bench_ksearch.py's cell and the default search; see
    the module docstring, phase 35."""
    from gptorch_tpu_torch import structure

    out = {"launches": {}, "readings": {}}
    searches = {"bench_ksearch": (KS_N, np.float32, dict(bases=("Rbf", "Linear"), max_depth=2, max_iter=KS_ITERS)),
                "default": (KS_DEFAULT_N, np.float64, dict(max_iter=KS_DEFAULT_ITERS))}
    with new_path_grams(torch) as (shapes, held):
        for name, (n, dtype, kw) in searches.items():
            x, y = ksearch_data(n, dtype)
            with lbfgs_evaluations() as evals, default_dtype(torch, torch.float64 if dtype == np.float64 else
                                                              torch.float32):
                res = timed_reading(torch, out, name, lambda: structure.kernel_search(x, y, device="cuda", **kw))
            ms = out["readings"][name]["ms"]
            out[name] = {"n": n, "dtype": np.dtype(dtype).name, "expression": res.expression, "score": res.score,
                         "candidates": len(res.history), "candidates_per_min": 60e3 * len(res.history) / ms,
                         "lbfgs_evaluations": evals[0], "lbfgs_iterations": evals[1]}
            check(np.isfinite(res.score), f"kernel_search {name}: non-finite score")
        t0 = time.perf_counter()
        out["card_vs_cpu"] = ksearch_card_vs_cpu(torch, structure)
        out["card_vs_cpu"]["s"] = time.perf_counter() - t0
    check(out["launches"]["rbf_gram"] > 0, "kernel_search never launched rbf_gram")
    out["held"] = check_held_grams(held, "kernel_search")
    out["rbf_gram_shapes"] = unheld_shapes(shapes, held)
    out["peak_mem_gb"] = max(r["peak_gb"] for r in out["readings"].values())
    print("# kernel_search: " + "; ".join(
        f"{name} n={o['n']} {o['dtype']}: {o['candidates']} candidates in {out['readings'][name]['ms'] / 1e3:.2f} s "
        f"({o['candidates_per_min']:.1f} a minute), '{o['expression']}' (BIC {o['score']:.3f}), {o['lbfgs_evaluations']} "
        f"L-BFGS evaluations over {o['lbfgs_iterations']} iterations, {out['readings'][name]['rbf_gram']} K1 launches"
        for name, o in ((k, out[k]) for k in searches))
          + f"; the float64 check {out['card_vs_cpu']['s']:.1f} s; peak {out['peak_mem_gb']:.3f} GB", flush=True)
    return out


def ksearch_card_vs_cpu(torch, structure):
    """bench_ksearch.py's search in float64, the card against the CPU: the
    same expression and history, scores to KS_REL_TOL relative."""
    x, y = ksearch_data(KS_N, np.float64)
    runs = {}
    for device in ("cpu", "cuda"):
        with default_dtype(torch, torch.float64):
            runs[device] = structure.kernel_search(x, y, bases=("Rbf", "Linear"), max_depth=2, max_iter=KS_ITERS,
                                                   device=device)
    a, b = runs["cuda"], runs["cpu"]
    gap = max(abs(s.score - t.score) / abs(t.score) for s, t in zip(a.history, b.history))
    same = a.expression == b.expression and [s.expression for s in a.history] == [s.expression for s in b.history]
    print(f"# kernel_search f64 n={KS_N}: card '{a.expression}' vs CPU '{b.expression}', histories the same {same}, "
          f"max relative score gap {gap:.3e} (tol {KS_REL_TOL})", flush=True)
    check(same and gap <= KS_REL_TOL, f"kernel_search f64 card vs CPU: {a.expression} vs {b.expression}, gap {gap}")
    return {"expression": a.expression, "gap": gap}


def checkpoint_phase(torch):
    """Checkpoint round trips of the serving model, a StreamingVFE and an
    OnlineSGPR, load_trainable under a cached fit_scan graph, and the
    profiling hooks; see the module docstring, phase 35."""
    from gptorch_tpu_torch import kernels, likelihoods, settings
    from gptorch_tpu_torch.models import GPR
    from gptorch_tpu_torch.training import checkpoint, fit

    out = {"launches": {}, "readings": {}}
    x, y, xq = make_data(N, D, np.float32)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    with new_path_grams(torch) as (shapes, held), settings.override(jitter_policy="fixed"):
        def serving_model():
            return GPR(x, y, kernels.Rbf(D, ARD=True), likelihood=likelihoods.Gaussian(0.1), fast=True,
                       fast_block=TRAIN_NB, fast_jitter=TRAIN_JITTER)

        model = serving_model()
        start = os.path.join(tmp, "start.npz")
        with counted(out["launches"]):
            checkpoint.save_trainable(start, model)
            first = fit.fit_scan(model, "Adam", max_iter=CK_STEPS, learning_rate=TRAIN_LR)[1].cpu()
            check_captured("checkpoint")
            merge_counts(out["launches"], replayed_launches())
            graphs = len(fit._GRAPHS.get(model, {}))
            checkpoint.load_trainable(start, model)
            again = fit.fit_scan(model, "Adam", max_iter=CK_STEPS, learning_rate=TRAIN_LR)[1].cpu()
            merge_counts(out["launches"], replayed_launches())
            check(len(fit._GRAPHS.get(model, {})) == graphs, "checkpoint: load_trainable made fit_scan capture anew")
            fresh = checkpoint.load_trainable(start, serving_model())
            want = fit.fit_scan(fresh, "Adam", max_iter=CK_STEPS, learning_rate=TRAIN_LR)[1].cpu()
            merge_counts(out["launches"], replayed_launches())
            full = os.path.join(tmp, "serving.npz")
            checkpoint.save(full, model)
            loaded = checkpoint.load(full, serving_model())
            with torch.no_grad():
                l_model, l_loaded = float(model.loss()), float(loaded.loss())
                p_model, p_loaded = model.posterior().predict_f(xq[0]), loaded.posterior().predict_f(xq[0])
        out["replay_vs_fresh"] = float((again - want).abs().max() / want.abs().max())
        out["first_vs_fresh"] = float((first - want).abs().max() / want.abs().max())
        out["serving_loss_gap"] = abs(l_model - l_loaded) / abs(l_model)
        out["serving_predict_gap"] = max(float(np.abs(a - b).max() / np.abs(a).max()) for a, b in zip(p_model, p_loaded))
        del model, fresh, loaded
        torch.cuda.empty_cache()
        out["streaming"], out["online"] = sparse_checkpoints(torch, tmp, checkpoint)
    out["profiling"] = run_profiling_check(tmp)
    for key in ("replay_vs_fresh", "first_vs_fresh", "serving_loss_gap", "serving_predict_gap"):
        check(out[key] <= CK_F32_TOL, f"checkpoint: {key} {out[key]} > {CK_F32_TOL}")
    check(out["launches"]["rbf_gram"] > 0, "the checkpoint path never launched rbf_gram")
    out["held"] = check_held_grams(held, "checkpoint")
    out["rbf_gram_shapes"] = unheld_shapes(shapes, held)
    print(f"# checkpoint: serving model (n={N}) {CK_STEPS} captured Adam steps after load_trainable replay the cached "
          f"graph, losses {again.tolist()} vs a fresh model from the file {want.tolist()} (max relative "
          f"{out['replay_vs_fresh']:.1e}); full save/load loss gap {out['serving_loss_gap']:.1e}, predict_f gap "
          f"{out['serving_predict_gap']:.1e}; StreamingVFE {out['streaming']}; OnlineSGPR {out['online']}; profiling "
          f"{out['profiling']}; launches {out['launches']}", flush=True)
    return out


def sparse_checkpoints(torch, tmp, checkpoint):
    """save/load of a StreamingVFE streamed over the sparse cell (float32)
    and of an OnlineSGPR after one step of its first batch (float64, "none"
    policy, phase 29's shapes): bound or predict_f gaps of the loaded model,
    which must be 0."""
    from gptorch_tpu_torch import settings

    x, y, z = sparse_data(SP_N, SP_D, SP_M, np.float32)
    xq = torch.as_tensor(x[:Q], device="cuda")
    with torch.no_grad():
        s = stream_model(torch, np.float32, z=z)
        for xb, yb in stream_batches(torch, x, y, np.float32):
            s = s.update(xb, yb)
        path = os.path.join(tmp, "stream.npz")
        checkpoint.save(path, s)
        loaded = checkpoint.load(path, stream_model(torch, np.float32, z=z))
        bound = float(s.log_likelihood())
        mean = s.predict_f(xq)[0]
        stream = {"bound_gap": abs(bound - float(loaded.log_likelihood())) / abs(bound),
                  "mean_gap": float((mean - loaded.predict_f(xq)[0]).abs().max() / mean.abs().max()),
                  "n_seen": float(loaded.n_seen)}
    x64, y64, z64 = x.astype(np.float64), y.astype(np.float64), z.astype(np.float64)
    with settings.override(jitter_policy="none"):
        o = online_model(torch, np.float64, z64)
        o.step(x64[:SP_BATCH], y64[:SP_BATCH], fit_iters=5, learning_rate=ON_LR)
        path = os.path.join(tmp, "online.npz")
        checkpoint.save(path, o)
        target = online_model(torch, np.float64, z64)
        target.step(x64[:64], y64[:64], fit_iters=0)  # makes the old-state slots
        loaded = checkpoint.load(path, target)
        with torch.no_grad():
            (m0, v0), (m1, v1) = o.predict_f(xq.double()), loaded.predict_f(xq.double())
        online = {"mean_gap": float((m0 - m1).abs().max() / m0.abs().max()),
                  "var_gap": float((v0 - v1).abs().max() / v0.abs().max())}
    for name, gaps, tol in (("StreamingVFE", stream, CK_F32_TOL), ("OnlineSGPR", online, CK_F64_TOL)):
        for key, gap in gaps.items():
            if key != "n_seen":
                check(gap <= tol, f"checkpoint {name}: {key} {gap} > {tol} after a round trip")
    check(stream["n_seen"] == float(SP_N), f"checkpoint StreamingVFE: n_seen {stream['n_seen']}")
    return stream, online


def profiling_check(log_dir):
    """profiling.trace around one serving predict_f with annotate("gram"):
    the trace file must name K1's kernel and the range, and
    device_memory_stats's peak must be torch's.  Prints the result as JSON
    and returns 0 or 1.  Run by a fresh process of this script
    (``--profiling-check DIR``): in a process that has traced ~300000
    device activities before (the earlier phases' torch.profiler sessions
    add up to that), later traces on an H100 hold no kernel records of a
    short window, with or without a pause at its start."""
    import torch

    from gptorch_tpu_torch import kernels, likelihoods, profiling, settings
    from gptorch_tpu_torch.models import GPR

    x, y, xq = make_data(N, D, np.float32)
    with settings.override(jitter_policy="fixed"):
        post = GPR(x, y, kernels.Rbf(D, ARD=True), likelihood=likelihoods.Gaussian(0.1)).posterior()
        post.predict_f(xq[1])  # warm
        launches = {}
        torch.cuda.synchronize()
        with counted(launches):
            with profiling.trace(log_dir):
                with profiling.annotate("gram"):
                    post.predict_f(xq[0])
                torch.cuda.synchronize()
    files = [os.path.join(root, f) for root, _, names in os.walk(log_dir) for f in names]
    events = json.load(open(files[0]))["traceEvents"] if files else []
    kernel_names = sorted({e["name"] for e in events if e.get("cat") == "kernel"})
    stats = profiling.device_memory_stats()
    out = {"files": len(files), "kernels": len(kernel_names),
           "names_rbf_gram_kernel": any("rbf_gram_kernel" in k for k in kernel_names),
           "names_gram_range": any(e.get("name") == "gram" for e in events), "rbf_gram": launches["rbf_gram"],
           "peak_equal": stats["peak_bytes_in_use"] == torch.cuda.max_memory_allocated(),
           "bytes_limit_gb": stats["bytes_limit"] / 1e9}
    print(json.dumps(out), flush=True)
    ok = out["files"] == 1 and out["names_rbf_gram_kernel"] and out["names_gram_range"] and out["peak_equal"]
    return 0 if ok and out["rbf_gram"] > 0 else 1


def run_profiling_check(tmp):
    """profiling_check in a fresh process of this script on the card: its
    JSON result, checked."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--profiling-check", os.path.join(tmp, "trace")],
                          capture_output=True, text=True, timeout=300)
    lines = [line for line in proc.stdout.splitlines() if line.startswith("{")]
    out = json.loads(lines[-1]) if lines else {"stdout": proc.stdout[-2000:], "stderr": proc.stderr[-2000:]}
    check(proc.returncode == 0, f"profiling: the trace does not name rbf_gram_kernel and the gram range, its peak is "
                                f"not torch's, or K1 did not launch: {out}")
    return out


def application_phases(torch):
    """The bayesopt, bayesopt_loop, design, metrics and structure and
    checkpoint phases, and K1's shapes on them checked against gram_phase's
    cases (or held as they launched); returns their results, the launches of
    each of their paths (counted over the path's own runs only), and the
    seconds they took together."""
    t0 = time.perf_counter()
    bo, post = bayesopt_phase(torch)
    out = {"bayesopt": bo, "bayesopt_loop": bayesopt_loop_phase(torch), "design": design_phase(torch, post)}
    out["metrics"] = metrics_phase(torch, post)
    del post
    torch.cuda.empty_cache()
    out["structure"] = structure_phase(torch)
    out["checkpoint"] = checkpoint_phase(torch)
    check_gram_coverage(set().union(*(result["rbf_gram_shapes"] for result in out.values())))
    paths = {"bayesopt": bo["launches"], "bayesopt_loop": out["bayesopt_loop"]["launches"],
             "design": out["design"]["launches"], "metrics": out["metrics"]["launches"],
             "kernel_search": out["structure"]["launches"], "checkpoint": out["checkpoint"]["launches"]}
    seconds = time.perf_counter() - t0
    print(f"# bayesopt, bayesopt_loop, design, metrics, structure and checkpoint phases: {seconds:.1f} s together; "
          f"launches by path {paths}", flush=True)
    return out, paths, seconds


@contextlib.contextmanager
def host_reads(torch):
    """Counts, in the one-element list it yields, the reads of card tensors
    from the host made inside the block (item, tolist, cpu, numpy, bool,
    float, int)."""
    count, names = [0], ("item", "tolist", "cpu", "numpy", "__bool__", "__float__", "__int__")
    saved = {name: getattr(torch.Tensor, name) for name in names}

    def wrap(fn):
        def counted_read(self, *args, **kwargs):
            if self.is_cuda:
                count[0] += 1
            return fn(self, *args, **kwargs)

        return counted_read

    for name, fn in saved.items():
        setattr(torch.Tensor, name, wrap(fn))
    try:
        yield count
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)


def mcmc_example_model(torch, device="cuda"):
    """The model of examples_torch/hyperparameter_mcmc.py (the twin of
    examples/hyperparameter_mcmc.py:45-55), in the default dtype."""
    from examples_torch import hyperparameter_mcmc

    return hyperparameter_mcmc.make_model(MC_EX_N, device=device)[2]


def timed_chains(torch, model, launches, **kw):
    """sample_posterior on ``model`` (MC_CHAINS chains, generator seeded 0 on
    the card), inside a counted block plus the replays' launches: (samples,
    result, reading) with the seconds, ms per transition, host reads per
    transition, whether it captured, and leapfrogs (batched over the
    chains) per transition."""
    from gptorch_tpu_torch import mcmc

    warm, draws = kw.setdefault("num_warmup", MC_WARM), kw.setdefault("num_samples", MC_DRAWS)
    generator = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    with host_reads(torch) as reads, counted(launches):
        t0 = time.perf_counter()
        samples, res = mcmc.sample_posterior(model, generator, num_chains=MC_CHAINS, **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    runner = mcmc.sample_posterior.last_run
    merge_counts(launches, runner.replayed_launches())
    transitions = warm + draws
    leapfrogs = sum(n * (key[1] if key[0] in ("hmc", "leaves") else 0) for key, n in runner.calls.items())
    reading = {"seconds": seconds, "ms_per_transition": 1e3 * seconds / transitions, "captured": runner.capture,
               "host_reads_per_transition": reads[0] / transitions, "host_reads": reads[0],
               "sampler_reads_per_transition": runner.reads / transitions,
               "leapfrogs_per_transition": leapfrogs / transitions, "graphs": len(runner.launches),
               "accept": float(res.accept_prob.mean()), "divergences": int(res.divergent.sum())}
    return samples, res, reading, runner


def chain_diagnostics(samples, name):
    from gptorch_tpu_torch import mcmc

    s = samples[name]
    return {"rhat": float(mcmc.potential_scale_reduction(s).max()), "ess": float(mcmc.effective_sample_size(s).min()),
            "mean": float(s.mean()), "sd": float(s.std())}


def mcmc_example_phase(torch):
    """mcmc_example and mcmc_nuts; see the module docstring, phase 36."""
    from gptorch_tpu_torch import mcmc, settings

    out = {"example": {"launches": {}, "runs": {}}, "nuts": {"launches": {}}}
    ex = out["example"]
    with default_dtype(torch, torch.float64):
        model = mcmc_example_model(torch)
        for policy in ("fixed", "adaptive"):
            size = {} if policy == "fixed" else {"num_warmup": MC_EAGER, "num_samples": MC_EAGER}
            with settings.override(jitter_policy=policy):
                samples, res, r, runner = timed_chains(torch, model, ex["launches"], num_leapfrog=MC_LEAPFROG, **size)
            r.update(chain_diagnostics(samples, "kernel.length_scales"))
            ex["runs"][policy] = r
            check(r["captured"] == (policy == "fixed"), f"mcmc_example {policy}: captured {r['captured']}")
            check(r["accept"] > 0.6 and r["divergences"] == 0, f"mcmc_example {policy}: {r}")
            if policy == "fixed":  # the full run: the JAX test's assertions, and no host read while it samples
                hmc_samples = samples
                check(r["host_reads"] == 0, f"mcmc_example captured: {r['host_reads']} host reads during sampling")
                check(r["rhat"] < 1.1 and r["ess"] > 100, f"mcmc_example fails the JAX test's assertions: {r}")
            warm, draws = size.get("num_warmup", MC_WARM), size.get("num_samples", MC_DRAWS)
            print(f"# mcmc_example {policy} policy ({'captured' if r['captured'] else 'eager'}; n={MC_EX_N}, "
                  f"Matern52, float64, {MC_CHAINS} chains x {warm} + {draws}, {MC_LEAPFROG} leapfrogs) on "
                  f"{card_line()}: {r['ms_per_transition']:.3f} ms a transition, {r['seconds']:.2f} s in all, "
                  f"{r['host_reads_per_transition']:.2f} host reads a transition ({r['graphs']} graphs); accept "
                  f"{r['accept']:.3f}, divergences {r['divergences']}, length scale {r['mean']:.3f} +- {r['sd']:.3f}, "
                  f"R-hat {r['rhat']:.4f}, ESS {r['ess']:.1f}", flush=True)
        xq = np.linspace(-4, 4, MC_EX_QUERIES)[:, None]
        with counted(ex["launches"]):
            mean, var = mcmc.predict_mixture(model, hmc_samples, xq)
            ex["predict_mixture_ms"] = time_ms(lambda: mcmc.predict_mixture(model, hmc_samples, xq), 3)
        point_mean, _ = model.predict_y(xq)
        check(bool(torch.isfinite(mean).all()) and bool((var > 1e-4).all()), "predict_mixture: bad moments")
        check(float((mean - torch.as_tensor(point_mean, device="cuda")).abs().max()) < 0.5,
              "predict_mixture: the mixture mean is far from the point prediction")
        print(f"# mcmc_example predict_mixture over {MC_CHAINS * MC_DRAWS} draws at {MC_EX_QUERIES} points: "
              f"{ex['predict_mixture_ms']:.3f} ms", flush=True)

        nu = out["nuts"]
        with settings.override(jitter_policy="fixed"):
            samples, res, r, runner = timed_chains(torch, model, nu["launches"], sampler="nuts",
                                                   max_depth=MC_NUTS_DEPTH)
        depth = res.tree_depth.double()
        r.update(depth_mean=float(depth.mean()), depth_max=int(depth.max()))
        nu["run"] = r
        check(r["captured"], "mcmc_nuts ran eagerly")
        check(r["divergences"] == 0 and r["accept"] > 0.6, f"mcmc_nuts: {r}")
        for name in samples:
            a, b = samples[name].ravel(), hmc_samples[name].ravel()
            check(abs(float(a.mean() - b.mean())) < max(float(a.std()), float(b.std())),
                  f"mcmc_nuts: {name} mean {float(a.mean())} against HMC's {float(b.mean())}")
            check(float(mcmc.potential_scale_reduction(samples[name]).max()) < 1.1, f"mcmc_nuts: {name} R-hat")
        print(f"# mcmc_nuts (captured, fixed policy, max depth {MC_NUTS_DEPTH}) on {card_line()}: "
              f"{r['ms_per_transition']:.3f} ms a transition, {r['seconds']:.2f} s in all, tree depth mean "
              f"{r['depth_mean']:.2f} max {r['depth_max']}, {r['host_reads_per_transition']:.2f} host reads a "
              f"transition, {r['leapfrogs_per_transition']:.2f} leapfrogs a transition ({r['graphs']} graphs); "
              f"accept {r['accept']:.3f}, divergences {r['divergences']}", flush=True)
    return out


def fused_mcmc_model(torch, dtype, fast=True):
    """Rbf-ARD with LogNormal(0, 1) priors on bench.py's data at n =
    MC_FUSED_N, d = 8, the float32 fused path's relative jitter in either
    type: the fused path (``fast=False``: the generic one)."""
    from gptorch_tpu_torch import kernels, likelihoods, priors
    from gptorch_tpu_torch.models import GPR
    from gptorch_tpu_torch.param import positive_param

    x, y, _ = make_data(MC_FUSED_N, D, dtype, seed=37)
    with default_dtype(torch, torch.float32 if dtype == np.float32 else torch.float64):
        kernel = kernels.Rbf(D, ARD=True)
        kernel.variance = positive_param(1.0, prior=priors.LogNormal(0.0, 1.0))
        kernel.length_scales = positive_param(np.ones(D), prior=priors.LogNormal(0.0, 1.0))
        return GPR(x, y, kernel, likelihood=likelihoods.Gaussian(0.1), fast=fast, fast_rel_jitter=1e-6,
                   device="cuda")


def chained_value_and_grad(model):
    """The chains' log posterior and its gradient, as sample_posterior
    evaluates them (value_and_grad of a (chains, dim) tensor), the same for
    one chain alone outside ``torch.func`` (the fused losses' eager form),
    and the model's flat raw values."""
    import torch

    from gptorch_tpu_torch import mcmc
    from gptorch_tpu_torch.module import get_trainable

    q0, unravel = mcmc._ravel(get_trainable(model), model.device)
    logpi = mcmc.log_posterior_fn(model)

    def alone(q):
        with torch.enable_grad():
            q = q.detach().requires_grad_(True)
            logp = logpi(unravel(q))
            (grad,) = torch.autograd.grad(logp, q)
        return logp.detach(), grad

    return mcmc._batched_value_and_grad(lambda q: logpi(unravel(q))), alone, q0


def relative_gaps(a, b):
    """(the largest relative gap of the log densities, the largest gap of
    the gradients relative to the reference's largest entry, per chain)
    between ``a`` and the reference ``b``, each (log densities, gradients)."""
    (lp, g), (lp_ref, g_ref) = a, b
    value = float(((lp.double() - lp_ref.double()).abs() / lp_ref.double().abs()).max())
    grad = float(((g.double() - g_ref.double()).abs().amax(-1) / g_ref.double().abs().amax(-1)).max())
    return value, grad


def fused_term_scale(torch, model, q):
    """Per chain of the raw values ``q`` (chains, dim: the D log length
    scales, log variance, log noise), the largest over coordinates of
    |∂ data fit| + |∂ log det| of the fused NLML, in float64 by plain torch:
    the two halves of the gradient, which cancel near a mode while
    float32's error stays at their size."""
    X, Y = model.X.double(), model.Y.double()
    out = []
    for row in q.double():
        raw = row.detach().clone().requires_grad_(True)
        with torch.enable_grad():
            xs = X / torch.exp(raw[:D])
            sq = torch.sum(xs * xs, dim=1)
            r2 = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * xs @ xs.T, min=0.0)
            diag = torch.exp(raw[D + 1]) + model.fast_jitter + model.fast_rel_jitter * torch.exp(raw[D])
            K = torch.exp(raw[D]) * torch.exp(-0.5 * r2) + diag * torch.eye(X.shape[0], dtype=X.dtype, device=X.device)
            L = torch.linalg.cholesky(K)
            fit = 0.5 * torch.sum(torch.linalg.solve_triangular(L, Y, upper=False) ** 2)
            logdet = Y.shape[1] * torch.sum(torch.log(torch.diagonal(L)))
            g_fit = torch.autograd.grad(fit, raw, retain_graph=True)[0]
            g_det = torch.autograd.grad(logdet, raw)[0]
        out.append(float((g_fit.abs() + g_det.abs()).max()))
        del K, L, r2
    torch.cuda.empty_cache()
    return out


def fused_f32_vs_f64(torch, vg, vg64, model64, q):
    """float32's chained value-and-grad against float64's at the raw values
    ``q`` (chains, dim): the log densities' largest relative gap, and the
    gradients' largest gap relative to :func:`fused_term_scale` (and, as a
    reading, to the gradient's own largest entry), each against 4·u·κ at the
    worst chain."""
    (lp, g), (lp64, g64) = vg(q), vg64(q.double())
    value = float(((lp.double() - lp64).abs() / lp64.abs()).max())
    gap = (g.double() - g64).abs().amax(-1)
    scale = torch.as_tensor(fused_term_scale(torch, model64, q), dtype=torch.float64, device=gap.device)
    kappa = max(rbf_kappa(torch, model64, row[:D], row[D], row[D + 1]) for row in q.double())
    return {"value_rel": value, "grad_rel": float((gap / scale).max()),
            "grad_rel_own": float((gap / g64.abs().amax(-1)).max()), "term_scale": scale.tolist(),
            "kappa_bound": kappa, "tol": 4 * F32_UNIT_ROUNDOFF * kappa}


def f32_vs_f64_text(f):
    return (f"log density rel {f['value_rel']:.3e}, gradient {f['grad_rel']:.3e} of the largest |d fit| + |d logdet| "
            f"({f['grad_rel_own']:.3e} of its own largest entry) (kappa <= {f['kappa_bound']:.1f}, tol 4*u*kappa = "
            f"{f['tol']:.3e})")


def f32_vs_f64_ok(f):
    return f["tol"] < 1 and max(f["value_rel"], f["grad_rel"]) <= f["tol"]


def fused_witness(torch):
    """From the model's own start and the JAX default first step, the
    chains after MC_WITNESS_WARM warmup transitions and one draw at the
    same seed: the fused path in float32 and float64, and the generic path
    (``fast=False``, the fixed jitter policy so that it captures) in
    float32; each chain's largest raw log length scale and adapted step."""
    from gptorch_tpu_torch import mcmc, settings

    out = {}
    for name, dtype, fast in (("fused f32", np.float32, True), ("generic f32", np.float32, False),
                              ("fused f64", np.float64, True)):
        model = fused_mcmc_model(torch, dtype, fast)
        generator = torch.Generator(device="cuda").manual_seed(0)
        with settings.override(jitter_policy="fixed"):
            t0 = time.perf_counter()
            _, res = mcmc.sample_posterior(model, generator, num_warmup=MC_WITNESS_WARM, num_samples=1,
                                           num_chains=MC_CHAINS, num_leapfrog=MC_FUSED_LEAPFROG)
            torch.cuda.synchronize()
        last = res.samples[:, -1].double()
        out[name] = {"max_raw_log_ell": [float(v) for v in last[:, :D].amax(-1)],
                     "step_size": [float(v) for v in res.step_size], "seconds": time.perf_counter() - t0,
                     "captured": mcmc.sample_posterior.last_run.capture}
        del model, res
        torch.cuda.empty_cache()
    return out


def mcmc_fused_phase(torch):
    """mcmc_fused; see the module docstring, phase 38."""
    from gptorch_tpu_torch import mcmc

    out = {"launches": {}, "n": MC_FUSED_N, "d": D, "dtype": "float32", "leapfrogs": MC_FUSED_LEAPFROG}
    model = fused_mcmc_model(torch, np.float32)
    check(model._fast_eligible(model.X) and not model._reads_jitter_policy(), "mcmc_fused is not on the fused path")
    vg, alone, q0 = chained_value_and_grad(model)
    # two chains at the model's own start, well conditioned: chain 0 there, chain 1 0.1·N(0, 1) from it
    offsets = torch.as_tensor(np.random.RandomState(1).randn(MC_CHAINS, q0.shape[0]), dtype=q0.dtype, device="cuda")
    offsets[0] = 0.0
    q = q0[None] + 0.1 * offsets
    with counted(out["launches"]):
        got = vg(q)
        vg_launches = read_counts()
        out["value_and_grad_ms"] = time_ms(lambda: vg(q), 3)
    check(vg_launches["rbf_gram"] == MC_CHAINS and vg_launches["radial_contractions"] == MC_CHAINS,
          f"mcmc_fused: one chained value-and-grad launched {vg_launches}, not K1 and K2 once per chain")
    # the vmap rule against each chain alone (the eager form, no vmap): the same kernels on the same values
    ref = [alone(row) for row in q]
    rule = relative_gaps(got, (torch.stack([r[0] for r in ref]), torch.stack([r[1] for r in ref])))
    chains_apart = relative_gaps((got[0][:1], got[1][:1]), (got[0][1:], got[1][1:]))
    model64 = fused_mcmc_model(torch, np.float64)
    vg64, _, _ = chained_value_and_grad(model64)
    out["rule"] = {"value_rel": rule[0], "grad_rel": rule[1], "tol": MC_FUSED_RULE_TOL,
                   "chains_apart": chains_apart, "f32_vs_f64": fused_f32_vs_f64(torch, vg, vg64, model64, q)}
    f = out["rule"]["f32_vs_f64"]
    print(f"# mcmc_fused at the model's start (chain 0 there, chain 1 0.1 N(0, 1) from it) on {card_line()}: one "
          f"chained value-and-grad {out['value_and_grad_ms']:.3f} ms; the vmap rule against each chain alone: log "
          f"density rel {rule[0]:.3e}, gradient {rule[1]:.3e} (tol {MC_FUSED_RULE_TOL}; the two chains differ by "
          f"{chains_apart[0]:.3e} and {chains_apart[1]:.3e}); f32 vs f64 {f32_vs_f64_text(f)}", flush=True)
    check(max(rule) <= MC_FUSED_RULE_TOL and min(chains_apart) > 100 * MC_FUSED_RULE_TOL,
          f"mcmc_fused: the vmap rule disagrees with each chain alone: {out['rule']}")
    check(f32_vs_f64_ok(f), f"mcmc_fused f32 vs f64 at the model's start: {f}")
    # the chains start from the MAP
    t0 = time.perf_counter()
    fit_losses = model.fit_scan("Adam", max_iter=MC_FUSED_FIT_STEPS, learning_rate=MC_FUSED_FIT_LR).cpu()
    out["fit"] = {"seconds": time.perf_counter() - t0,
                  "losses": [float(fit_losses[i]) for i in (0, MC_FUSED_FIT_STEPS // 2, -1)]}
    check(bool(torch.isfinite(fit_losses).all()) and out["fit"]["losses"][-1] < out["fit"]["losses"][0],
          f"mcmc_fused: the MAP fit did not descend: {out['fit']}")
    # warmup and draws sized to MC_FUSED_SECONDS of sampling at the eager value-and-grad's rate (the JAX default
    # is 500 + 500; a captured transition takes about half that)
    transitions = max(8, int(1e3 * MC_FUSED_SECONDS / (out["value_and_grad_ms"] * MC_FUSED_LEAPFROG)))
    warm = draws = transitions // 2
    out.update(warmup=warm, draws=draws)
    torch.cuda.reset_peak_memory_stats()
    samples, res, r, runner = timed_chains(torch, model, out["launches"], num_warmup=warm, num_samples=draws,
                                           num_leapfrog=MC_FUSED_LEAPFROG)
    out["run"] = r
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    # one graph a transition (warmup's and the draws'), each with K1 and K2 once per chain and leapfrog
    want = {"rbf_gram": MC_CHAINS * MC_FUSED_LEAPFROG, "radial_contractions": MC_CHAINS * MC_FUSED_LEAPFROG}
    per = {key[-2:]: {k: v[k] for k in want} for key, v in runner.launches.items()}
    out["launches_per_transition"] = want
    r["rhat_max"] = max(float(mcmc.potential_scale_reduction(v.reshape(v.shape[:2] + (-1,))).max())
                        for v in samples.values())
    r["max_raw_log_ell"] = float(res.samples[..., :D].max())
    # float32 against float64 at the last draw of each chain, 4·u·κ
    out["f32_vs_f64"] = f = fused_f32_vs_f64(torch, vg, vg64, model64, res.samples[:, -1].contiguous())
    del model64, vg64
    torch.cuda.empty_cache()
    print(f"# mcmc_fused (Rbf-ARD d={D}, n={MC_FUSED_N}, float32, fused path, captured, {MC_CHAINS} chains from the "
          f"MAP: {MC_FUSED_FIT_STEPS} captured Adam steps at lr {MC_FUSED_FIT_LR}, losses {out['fit']['losses']} in "
          f"{out['fit']['seconds']:.2f} s; the JAX default 500 + 500 at {MC_FUSED_LEAPFROG} leapfrogs cut to {warm} + "
          f"{draws} for {MC_FUSED_SECONDS:.0f} s) on {card_line()}: {r['ms_per_transition']:.2f} ms a transition, "
          f"{r['seconds']:.2f} s in all, {r['host_reads_per_transition']:.3f} host reads a transition, launches a transition's graph recorded "
          f"{per}; accept {r['accept']:.3f}, divergences {r['divergences']}, largest R-hat {r['rhat_max']:.4f} (limit "
          f"{MC_FUSED_RHAT}), largest raw log length scale {r['max_raw_log_ell']:.3f}; peak {out['peak_mem_gb']:.2f} "
          f"GB; f32 vs f64 at the last draw: {f32_vs_f64_text(f)}; launches {out['launches']}", flush=True)
    out["witness"] = w = fused_witness(torch)
    print(f"# mcmc_fused witness (from the model's start, first step 0.1, {MC_WITNESS_WARM} warmup transitions and "
          f"one draw, seed 0, n={MC_FUSED_N}, fixed jitter policy) on {card_line()}: "
          + "; ".join(f"{k}: largest raw log length scale by chain {v['max_raw_log_ell']}, adapted step "
                      f"{v['step_size']}, captured {v['captured']}, {v['seconds']:.1f} s" for k, v in w.items()),
          flush=True)
    check(r["captured"], "mcmc_fused ran eagerly")
    check(len(per) == 2 and all(v == want for v in per.values()),
          f"mcmc_fused: the transitions' graphs recorded {per} launches, not K1 and K2 on every leapfrog ({want})")
    check(all(bool(torch.isfinite(v).all()) for v in samples.values()), "mcmc_fused: non-finite draws")
    check(r["accept"] > 0.6 and r["divergences"] == 0 and r["rhat_max"] < MC_FUSED_RHAT,
          f"mcmc_fused: the chains from the MAP are not healthy: {r}")
    check(f32_vs_f64_ok(f), f"mcmc_fused f32 vs f64 at the last draw: {f}")
    check(all(math.isfinite(x) for v in w.values() for x in v["max_raw_log_ell"] + v["step_size"]),
          "mcmc_fused witness: non-finite chains")
    return out


def mcmc_latent_phase(torch):
    """mcmc_latent; see the module docstring, phase 39."""
    from gptorch_tpu_torch import kernels, likelihoods, mcmc
    from gptorch_tpu_torch.models import LaplaceGP

    out = {"launches": {}, "n": MC_LATENT_N, "dtype": "float32"}
    x = np.linspace(-2, 2, MC_LATENT_N)[:, None].astype(np.float32)
    y = (np.sin(2 * x) > 0).astype(np.float32)
    with default_dtype(torch, torch.float32):
        model = LaplaceGP(x, y, kernels.Rbf(1), likelihoods.Bernoulli(), device="cuda")
    generator = torch.Generator(device="cuda").manual_seed(3)
    transitions = MC_LATENT_BURN + MC_LATENT_DRAWS
    xq = np.linspace(-2, 2, MC_LATENT_QUERIES)[:, None].astype(np.float32)
    torch.cuda.synchronize()
    with host_reads(torch) as reads, counted(out["launches"]):
        t0 = time.perf_counter()
        chol = mcmc.latent_prior_chol(model)
        torch.cuda.synchronize()
        out["chol_ms"] = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        draws = mcmc.sample_latent(model, generator, num_samples=MC_LATENT_DRAWS, num_burn=MC_LATENT_BURN, chol=chol)
        torch.cuda.synchronize()
        out["sample_seconds"] = time.perf_counter() - t0
        mean, var = mcmc.predict_latent_mixture(model, draws, xq, chol=chol)
        out["predict_ms"] = time_ms(lambda: mcmc.predict_latent_mixture(model, draws, xq, chol=chol), 3)
    runner = mcmc.elliptical_slice.last_run
    merge_counts(out["launches"], runner.replayed_launches())
    counts = runner.shrinks.double()
    out.update(ms_per_transition=1e3 * out["sample_seconds"] / transitions, captured=runner.capture,
               shrinks_mean=float(counts.mean()), shrinks_max=int(counts.max()),
               host_reads_per_transition=reads[0] / transitions,
               bound_ms=1e3 * MC_LATENT_N * MC_LATENT_N * 4 / HBM_BYTES_PER_S)
    check(runner.capture, "mcmc_latent ran eagerly")
    check(bool(torch.isfinite(draws).all()) and bool(torch.isfinite(mean).all()) and bool((var >= 0).all()),
          "mcmc_latent: non-finite draws or moments")
    lap = model.predict_f(x)[0].ravel()
    corr = float(np.corrcoef(draws.mean(0).double().cpu().numpy().ravel(), lap)[0, 1])
    out["corr_with_laplace"] = corr
    check(corr > 0.99, f"mcmc_latent: the draws' mean correlates {corr} with the Laplace mode (JAX test: > 0.99)")
    check(out["launches"]["rbf_gram"] > 0, "mcmc_latent never launched rbf_gram")
    print(f"# mcmc_latent (LaplaceGP Bernoulli, Rbf, n={MC_LATENT_N}, float32, {MC_LATENT_BURN} + {MC_LATENT_DRAWS}, "
          f"captured) on {card_line()}: prior factor {out['chol_ms']:.1f} ms; {out['ms_per_transition']:.3f} ms a "
          f"transition (bound: the ({MC_LATENT_N}, {MC_LATENT_N}) x (n, 1) product read once, "
          f"{out['bound_ms']:.4f} ms), shrinks a transition mean {out['shrinks_mean']:.2f} max {out['shrinks_max']}, "
          f"{out['host_reads_per_transition']:.2f} host reads a transition; predict_latent_mixture at "
          f"{MC_LATENT_QUERIES} points {out['predict_ms']:.3f} ms; corr with the Laplace mode {corr:.5f}; launches "
          f"{out['launches']}", flush=True)
    return out


def mcmc_phases(torch):
    """The mcmc_example, mcmc_nuts, mcmc_fused and mcmc_latent phases, their
    K1 shapes held against the twin as they launch; returns their results,
    the launches of each path and the seconds they took together."""
    t0 = time.perf_counter()
    with new_path_grams(torch) as (shapes, held):
        example = mcmc_example_phase(torch)
        fused = mcmc_fused_phase(torch)
        latent = mcmc_latent_phase(torch)
    out = {"example": example["example"], "nuts": example["nuts"], "fused": fused, "latent": latent}
    out["held"] = check_held_grams(held, "mcmc")
    check_gram_coverage(unheld_shapes(shapes, held))
    paths = {"mcmc_example": example["example"]["launches"], "mcmc_nuts": example["nuts"]["launches"],
             "mcmc_fused": fused["launches"], "mcmc_latent": latent["launches"]}
    check(paths["mcmc_example"]["rbf_gram"] == 0 and paths["mcmc_nuts"]["rbf_gram"] == 0,
          "the Matern52 example launched rbf_gram")
    seconds = time.perf_counter() - t0
    print(f"# mcmc_example, mcmc_nuts, mcmc_fused and mcmc_latent phases: {seconds:.1f} s together; launches by path "
          f"{paths}", flush=True)
    return out, paths, seconds


@contextlib.contextmanager
def graph_replays(torch):
    """Counts, in the dict it yields (launches by kernel name), the kernel
    launches that replays of the CUDA graphs captured inside the block make:
    a graph's capture records the wrappers' launches between its
    capture_begin and capture_end, and each replay adds them.  A counter
    counts launches from the host, so a path's launches are its counters
    plus these (a replay of a graph captured before the block fails)."""
    from gptorch_tpu_torch import ops

    cls = torch.cuda.CUDAGraph
    begin, end, replay = cls.capture_begin, cls.capture_end, cls.replay
    tally, recorded, starts = dict.fromkeys(ops.launch_counts(), 0), {}, {}

    def capture_begin(self, *args, **kwargs):
        starts[id(self)] = ops.launch_counts()
        return begin(self, *args, **kwargs)

    def capture_end(self):
        out = end(self)
        before, after = starts.pop(id(self)), ops.launch_counts()
        recorded[id(self)] = (self, {k: after[k] - before[k] for k in after})
        return out

    def counted_replay(self):
        check(id(self) in recorded, "a CUDA graph captured outside the counted block was replayed")
        for k, v in recorded[id(self)][1].items():
            tally[k] += v
        return replay(self)

    cls.capture_begin, cls.capture_end, cls.replay = capture_begin, capture_end, counted_replay
    try:
        yield tally
    finally:
        cls.capture_begin, cls.capture_end, cls.replay = begin, end, replay
        recorded.clear()


@contextlib.contextmanager
def held_contractions(torch):
    """Holds the first K2 launch of each (n, d, dy, kind, dtype) made inside
    the block through the fused NLML, where contraction_phase does not
    cover it, against the plain twin in float64 on the same inputs (outside
    a graph capture; the warm step before a capture is held), relative to
    each output's sum of absolute terms: yields {key: that error}, read by
    check_held_contractions.  Every key launched is also added to the set
    at its "launched" entry."""
    from gptorch_tpu_torch.ops import contract, gpr_fast

    covered = {(4096, D, 1, kind, name) for kind in KINDS for name in TOL} | {(N, D, 1, "rbf", "float32")}
    held, launched, launch = {}, set(), gpr_fast.radial_contractions

    def holding(Kinv, A, xs, log_var, dy, kind, log_extra=None):
        out = launch(Kinv, A, xs, log_var, dy, kind, log_extra)
        key = (xs.shape[0], xs.shape[1], dy, kind, dtype_name(xs.dtype))
        launched.add(key)
        if key not in covered and key not in held and not torch.cuda.is_current_stream_capturing():
            with torch.no_grad():
                ref = [t.double() for t in (Kinv, A, xs, torch.as_tensor(log_var))]
                extra = log_extra.double() if log_extra is not None else None
                want = contract.radial_contractions_plain(*ref, dy, kind, extra)
                scales = contract.contraction_scales(*ref, dy, kind, extra)
                held[key] = max(float(((a.double() - b).abs() / c.clamp_min(1e-300)).max())
                                for a, b, c in zip(out, want, scales))
        return out

    gpr_fast.radial_contractions = holding
    try:
        yield {"held": held, "launched": launched, "covered": covered}
    finally:
        gpr_fast.radial_contractions = launch


def check_held_contractions(k2, what):
    """Fails unless every K2 launch held by held_contractions agrees with the
    twin to contraction_phase's limit, and every key launched was covered
    or held."""
    held = k2["held"]
    unheld = sorted(k for k in k2["launched"] if k not in held and k not in k2["covered"])
    print(f"# {what}: K2 launched at {sorted(k2['launched'])}; held against the twin as they launched: "
          f"{ {k: f'{v:.3e}' for k, v in held.items()} } (tol {CONTRACT_TOL}); neither covered nor held: {unheld}",
          flush=True)
    check(not unheld, f"{what}: radial_contractions launched at {unheld} without a check against the twin")
    for key, err in held.items():
        check(err <= CONTRACT_TOL[key[4]], f"{what}: radial_contractions at {key} error {err} against the twin")
    return {"held": len(held), "worst": max(held.values(), default=0.0)}


def run_example(case, args):
    """The main(args) of the twin that ``case`` names first
    (``examples_torch.<name>``) in this process: (its result dict, its
    standard output)."""
    import importlib
    import io

    module = importlib.import_module(f"examples_torch.{case.split()[0]}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = module.main(args)
    return result, out.getvalue()


@contextlib.contextmanager
def scaled_regression_inputs(factor):
    """examples_torch/regression_1d.py's inputs times ``factor`` inside the
    block."""
    from examples_torch import regression_1d

    get_data = regression_1d.get_data
    regression_1d.get_data = lambda *args, **kw: (lambda x, y: (x * factor, y))(*get_data(*args, **kw))
    try:
        yield
    finally:
        regression_1d.get_data = get_data


def examples_cpu_reference(path):
    """The CPU side of examples_card_vs_cpu: EX_CHECK's twins on the CPU in
    float64, their compared outputs written to ``path`` (npz), and
    regression_1d's again with its inputs scaled by 1 + EX_SCALE (keys
    ending ":scaled").  Run by a background process of this script
    (``--examples-cpu-reference PATH``) on two cores."""
    import torch

    torch.set_num_threads(2)
    out = {}
    with default_dtype(torch, torch.float64):
        for case, args, keys in EX_CHECK:
            runs = {"": contextlib.nullcontext}
            if case.startswith("regression_1d"):
                runs[":scaled"] = lambda: scaled_regression_inputs(1 + EX_SCALE)
            for suffix, context in runs.items():
                with context():
                    result, _ = run_example(case, args + ["--device", "cpu", "--no-plot"])
                out.update({f"{case}:{k}{suffix}": np.asarray(result[k]) for k in keys})
    np.savez(path, **out)
    return 0


def examples_card_vs_cpu(torch, reference):
    """EX_CHECK's twins on the card in float64 against the CPU's runs of
    :func:`examples_cpu_reference` (waited for here): the largest gap of
    each output relative to its largest entry."""
    proc, path, log = reference
    gaps = {}
    with default_dtype(torch, torch.float64):
        card = {case: run_example(case, args + ["--device", "cuda", "--no-plot"])[0] for case, args, _ in EX_CHECK}
    t0 = time.perf_counter()
    code = proc.wait()
    waited = time.perf_counter() - t0
    with open(log) as f:
        check(code == 0, f"the examples' CPU reference failed ({code}): {f.read()[-2000:]}")
    cpu = np.load(path)

    def gap(a, b):
        return float(np.max(np.abs(np.asarray(a, dtype=np.float64) - b)) / np.max(np.abs(b)))

    spread = {}
    for case, _, keys in EX_CHECK:
        for k in keys:
            gaps[f"{case} {k}"] = gap(card[case][k], cpu[f"{case}:{k}"])
            if f"{case}:{k}:scaled" in cpu:
                spread[f"{case} {k}"] = gap(cpu[f"{case}:{k}:scaled"], cpu[f"{case}:{k}"])
    limits = {f"{case} {k}": tol for case, _, tols in EX_CHECK for k, tol in tols.items()}
    print(f"# examples card vs CPU in float64 on {card_line()} (regression_1d GPR and VFE, serving --n 512; waited "
          f"{waited:.1f} s for the CPU): largest gap relative to the largest entry "
          f"{ {k: f'{v:.3e} (tol {limits[k]:.0e})' for k, v in gaps.items()} }; the CPU's own outputs with "
          f"regression_1d's inputs scaled by 1 + {EX_SCALE:.0e} move by { {k: f'{v:.3e}' for k, v in spread.items()} }",
          flush=True)
    for k, v in gaps.items():
        check(v <= limits[k], f"examples card vs CPU: {k} gap {v} > {limits[k]}")
    return gaps


def examples_phases(torch, reference):
    """The examples group: each case of EX_CASES through its twin's main on
    the card, its K1 and K2 launches counted over its own run (graph
    replays included), every K1 and K2 shape held against the plain twin as
    it launches (or covered by the kernel phases), the JAX test's
    assertions checked; then the float64 card-vs-CPU check.  Returns the
    results, the launches of each example (a path of its own) and the
    seconds the group took."""
    t0 = time.perf_counter()
    out, paths = {}, {}
    card = card_line()
    with new_path_grams(torch) as (shapes, held), held_contractions(torch) as k2:
        for case, args, markers in EX_CASES:
            cut = EX_CUTS.get(case, [])
            launches = {}
            torch.cuda.synchronize()
            with graph_replays(torch) as replays, counted(launches):
                t1 = time.perf_counter()
                result, text = run_example(case, args + cut + ["--device", "cuda", "--no-plot"])
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t1
            launches = add_counts(launches, replays)
            path = "example_" + case.replace(" ", "_")
            paths[path] = launches
            summary = {k: v for k, v in result.items() if isinstance(v, (bool, int, float, str))}  # unrounded
            out[case] = {"seconds": seconds, "summary": summary, "launches": launches, "cut": cut}
            for line in text.strip().splitlines():
                print(f"#   {case}: {line}", flush=True)
            print(f"# example {case} ({' '.join(args + cut) or 'defaults'}"
                  f"{'; cut from the defaults: ' + ' '.join(cut) if cut else ''}) on {card}: {seconds:.2f} s; "
                  f"K1 {launches['rbf_gram']}, K2 {launches['radial_contractions']} launches; {summary}", flush=True)
            for marker in markers:
                check(EX_REPLACED.get(marker, marker) in text, f"example {case}: {marker!r} missing from {text!r}")
            if case in EX_NO_K1:
                check(launches["rbf_gram"] == 0, f"example {case} launched rbf_gram")
            else:
                check(launches["rbf_gram"] > 0, f"example {case} never launched rbf_gram")
        k1_held = check_held_grams(held, "examples")
        check_gram_coverage(unheld_shapes(shapes, held))
        k2_held = check_held_contractions(k2, "examples")
    ex = out
    check(ex["serving"]["launches"]["rbf_gram"] >= 60 and ex["serving"]["launches"]["radial_contractions"] >= 60,
          f"example serving: K1 and K2 should launch in each of its 60 fused steps: {ex['serving']['launches']}")
    check(ex["streaming_gp"]["summary"]["rel_diff"] < 1e-3, f"example streaming_gp: {ex['streaming_gp']['summary']}")
    check(ex["derivative_gp"]["summary"]["improvement"] > 2.0, f"example derivative_gp: {ex['derivative_gp']}")
    check(ex["serving"]["summary"]["err"] < 1e-2, f"example serving: {ex['serving']['summary']}")
    out["held"] = {"k1": k1_held, "k2": k2_held}
    out["card_vs_cpu"] = examples_card_vs_cpu(torch, reference)
    seconds = time.perf_counter() - t0
    print(f"# examples group on {card}: {seconds:.1f} s together; seconds by example "
          f"{ {c: round(r['seconds'], 2) for c, r in ex.items() if isinstance(r, dict) and 'seconds' in r} }; "
          f"launches by path {paths}", flush=True)
    return out, paths, seconds


KERNEL_SOURCES = ("rbf_gram", "radial_contract", "radial_mvm", "lowrank_contract")


def build_kernels(names=KERNEL_SOURCES):
    """Builds the kernel sources ``names`` of the package on ``sys.path``
    (one nvcc each, all started together) and loads them: (seconds, their
    wrapper modules in the order of ``names``, the build logs)."""
    from gptorch_tpu_torch.ops import _build, contract, gram, lowrank_contract, mvm

    modules = dict(zip(KERNEL_SOURCES, (gram, contract, mvm, lowrank_contract)))
    t0 = time.perf_counter()
    _build.build(list(names))
    ops = tuple(modules[name] for name in names)
    for module in ops:
        module._kernel_library()
    return time.perf_counter() - t0, ops, _build.build_logs


def start_build(names):
    """The nvcc builds of the kernel sources ``names`` in a background
    thread (the compilers run beside the caller's work); returns a function
    that waits for them, loads the libraries in the calling thread and
    returns :func:`build_kernels`'s result with the seconds from the start
    to the builds' end.  The wait for the thread is also registered to run
    at exit, so no nvcc outlives the script."""
    import threading

    from gptorch_tpu_torch.ops import _build

    t0, result = time.perf_counter(), []

    def run():
        try:
            _build.build(list(names))
            result.append(time.perf_counter() - t0)
        except Exception as exc:  # raised again by the wait
            result.append(exc)

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    atexit.register(thread.join)

    def wait():
        thread.join()
        if isinstance(result[0], Exception):
            raise result[0]
        _, ops, logs = build_kernels(names)
        return result[0], ops, logs

    return wait


def kernel_phases(torch, cs, ops):
    """K1, K2, K3 and K4 against their twins and timed: the kernel phases of
    the smoke module ``cs`` in order, on the kernel modules ``ops`` of
    :func:`build_kernels`.  main() runs this file's; the comparison mode
    another checkout's."""
    gram, contract, mvm, lowrank = ops
    return (cs.gram_phase(torch, gram), cs.contraction_phase(torch, contract), cs.mvm_phase(torch, mvm),
            cs.lowrank_phase(torch, lowrank))


def lowrank_rank_sweep(torch, lowrank, ranks=(9, 17, 24, 32)):
    """K4 timed at the path's shape (n = 100000, d = 8, rbf, float32) for
    each r of ``ranks``, all launches a call makes, with its launch count."""
    for r in ranks:
        xs, W, lv, _ = radial_inputs(torch, IT_N, 2 * r, torch.float32, seed=300 + r)
        Wl, Wr, var = W[:, :r].contiguous(), W[:, r:].contiguous(), torch.exp(lv)
        before = lowrank.lowrank_contractions.launches
        lowrank.lowrank_contractions("rbf", xs, var, Wl, Wr)
        launches = lowrank.lowrank_contractions.launches - before
        ms = time_ms(lambda: lowrank.lowrank_contractions("rbf", xs, var, Wl, Wr), 5)
        print(f"## K4 rank sweep rbf float32 n={IT_N} d={D} r={r}: {ms:.3f} ms, {launches} launch(es) a call, "
              f"bound {lowrank_bound_ms(IT_N, D, r, 'float32', 4)[0]:.3f} ms", flush=True)
        del xs, W, Wl, Wr
        torch.cuda.empty_cache()


def compare_side(checkout) -> int:
    """One side of a comparison of two commits on one card: this script's
    kernel phases (:func:`kernel_phases`, so both sides print the same
    readings, K1's card time included) on the package of ``checkout``, a
    directory holding a copy of the repository (``git archive``) that builds
    its kernels under its own ``build/``; then K4 over ranks 9 to 32 and the
    matrix-free value-and-grad (one warm, three timed) and its stages from
    that checkout's chip_smoke.py.  Run it for parent, change, change,
    parent in one call, so that every number of the comparison comes from
    one card."""
    import importlib

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    this = sys.modules[__name__]
    checkout = os.path.abspath(checkout)
    os.chdir(checkout)
    sys.path.insert(0, checkout)
    cs = importlib.import_module("chip_smoke")
    print(f"## {checkout} on {card_line()}", flush=True)
    seconds, ops, _ = build_kernels()
    print(f"## build {seconds:.1f} s", flush=True)
    kernel_phases(torch, this, ops)
    lowrank_rank_sweep(torch, ops[3])
    model, _ = cs.iterative_model(cs.IT_N, np.float32)
    cs.iterative_value_and_grad(torch, model)
    times = [time_ms(lambda: cs.iterative_value_and_grad(torch, model), 1) for _ in range(3)]
    print(f"## matrix-free value-and-grad ms: {', '.join(f'{t:.2f}' for t in times)}", flush=True)
    cs.iterative_stages(torch, model)
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    card = card_line()
    print(card, flush=True)
    t_start = time.perf_counter()
    # all four nvcc start together; K3's and K4's sources (hundreds of
    # instances) take most of the build and finish in the background while
    # the exact paths, which launch only K1 and K2 and whose readings the
    # card bounds, run; the kernel phases follow on an idle host
    matrix_free_build = start_build(KERNEL_SOURCES[2:])
    seconds, (gram, contract), build_logs = build_kernels(KERNEL_SOURCES[:2])
    print(f"# build of rbf_gram and radial_contract {seconds:.2f} s", flush=True)

    phase_s, last = {}, [time.perf_counter()]

    def done(name):
        """Records the seconds since the last phase ended under ``name``."""
        now = time.perf_counter()
        phase_s[name] = round(now - last[0], 1)
        last[0] = now

    serving = serving_phase(torch, gram, contract)
    done("serving")
    training = training_phase(torch, gram, contract)
    done("training")
    general_training = general_training_phase(torch, gram, contract)
    done("general_training")
    observe_loop = observe_loop_phase(torch, gram, contract)
    done("observe_loop")
    seconds, (mvm, lowrank), build_logs = matrix_free_build()
    print(f"# build of radial_mvm and lowrank_contract {seconds:.2f} s (from the start, beside phases 3-6)", flush=True)
    for name, log in build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"# nvcc {name}: {line.strip()}", flush=True)
    # every K1 instance: the mapping, its type and (tiles) 16-byte stores and mirroring
    for kernel, (regs, stores, loads) in sorted(ptxas_report(build_logs.get("rbf_gram", ""), r"rbf_gram_kernel").items()):
        print(f"# ptxas rbf_gram {k1_instance(kernel)}: {regs} registers, {stores} bytes spill stores, {loads} bytes "
              f"spill loads", flush=True)
    # K4's instances (type, kind, MAXD, P = 2r rounded up); the matrix-free backward's is float32, rbf, 8, 20
    k4 = ptxas_report(build_logs.get("lowrank_contract", ""), r"lowrank_kernelI")
    for kernel, (regs, stores, loads) in sorted(k4.items()):
        t, kind, maxd, p = re.search(r"lowrank_kernelI([fd])Li(\d)ELi(\d+)ELi(\d+)E", kernel).groups()
        if (t, kind, maxd, p) == ("f", "0", "8", "20") or stores:
            print(f"# ptxas lowrank_contractions {'float32' if t == 'f' else 'float64'} {KINDS[int(kind)]} MAXD={maxd} "
                  f"P={p}: {regs} registers, {stores} bytes spill stores, {loads} bytes spill loads", flush=True)
    done("build_wait")
    ops = (gram, contract, mvm, lowrank)
    gram_rows, contract_rows, mvm_rows, lowrank_rows = kernel_phases(torch, sys.modules[__name__], ops)
    done("kernels")
    svgp, svgp_training = svgp_training_phase(torch, gram, contract)
    vfe_serving = sparse_serving_phase(torch, gram, contract, svgp, "vfe")
    svgp_serving = sparse_serving_phase(torch, gram, contract, svgp, "svgp")
    del svgp
    torch.cuda.empty_cache()
    svgp_training["card_vs_cpu"] = sparse_card_vs_cpu(torch, gram, contract)
    done("sparse")
    svgp_captured = svgp_captured_phase(torch, gram, contract, svgp_training)
    dkl = dkl_studentt_svgp_phase(torch, gram, contract)
    done("svgp_captured_and_dkl")
    # the iterative check's CPU side (minutes on the host, half the cores)
    # starts with the zoo phases, whose readings the card bounds, so that it
    # is done when phase 15 needs it and the host-bound readings above ran
    # on an idle host
    # the zoo check's CPU side starts with it, on the card's iterates, and
    # both are collected after the iterative phases' card work
    reference, zoo_check = start_reference("--iterative-cpu-reference", "iterative_cpu.npz"), None
    examples_reference = start_reference("--examples-cpu-reference", "examples_cpu.npz")
    atexit.register(stop_process, examples_reference[0])
    try:
        zoo_check = start_zoo_check(torch)
        zoo_grams = zoo_grams_phase(torch, gram, contract)
        zoo_training = zoo_training_phase(torch, gram, contract)
        done("zoo")
        it_model, it_queries, iterative_training = iterative_training_phase(torch)
        iterative_serving = iterative_serving_phase(torch, it_model, it_queries)
        it_pathwise = pathwise_iterative_phase(torch, it_model)
        del it_model
        torch.cuda.empty_cache()
        iterative_training["card_vs_cpu"] = iterative_card_vs_cpu(torch, reference)
        zoo_training["card_vs_cpu"] = zoo_card_vs_cpu(zoo_check)
    finally:
        stop_process(reference[0])
        if zoo_check is not None:
            stop_process(zoo_check[1])
    done("iterative")
    latent, latent_s = latent_and_vecchia_phases(torch)
    done("latent_and_vecchia")
    structured, structured_s = structured_phases(torch)
    done("structured")
    fleet, fleet_paths, fleet_s = fleet_phases(torch)
    done("fleet")
    variants, variant_paths, variants_s = sparse_variant_phases(torch, it_pathwise)
    done("sparse_variants")
    apps, app_paths, apps_s = application_phases(torch)
    done("applications")
    mc, mc_paths, mc_s = mcmc_phases(torch)
    done("mcmc")
    try:
        examples, example_paths, examples_s = examples_phases(torch, examples_reference)
    finally:
        stop_process(examples_reference[0])
    done("examples")
    print(f"# seconds by phase group: {phase_s}", flush=True)

    paths = {"serving": serving["launches"], "training": training["launches"],
             "general_training": general_training["launches"], "observe_loop": observe_loop["launches"],
             "svgp_training": svgp_training["launches"], "vfe_serving": vfe_serving["launches"],
             "svgp_serving": svgp_serving["launches"], "svgp_captured": svgp_captured["launches"],
             "dkl_studentt_svgp": dkl["launches"], "zoo_grams": zoo_grams["launches"],
             "zoo_training": zoo_training["launches"], "iterative_training": iterative_training["launches"],
             "iterative_serving": iterative_serving["launches"],
             **{name: result["launches"] for name, result in latent.items()},
             **{name: result["launches"] for name, result in structured.items()},
             **fleet_paths, **variant_paths, **app_paths, **mc_paths, **example_paths}
    g, c = gram_rows[0], contract_rows[0]
    gb = next(r for r in gram_rows if r.get("batch") and r["dtype"] == "float32" and r["case"] == "fleet K")
    m9, lr = mvm_rows["timed"][9], lowrank_rows["timed"][IT_PROBES + 1]
    kernels_line = {"kernels": [
        {
            "name": "rbf_gram",
            "route": "cuda",
            "source": "gptorch_tpu_torch/csrc/rbf_gram.cu",
            "replaces": "gptorch_tpu/ops/pallas_gram.py:40",
            "launches": sum(p["rbf_gram"] for p in paths.values()),
            "launches_by_path": {k: p["rbf_gram"] for k, p in paths.items()},
            "max_abs_err": g["max_abs_err"],
            "ms": g["ms"],
            "plain_ms": g["plain_ms"],
            "bound_ms": g["bound_ms"],
            "bound_by": g["bound_by"],
            "library_ms": None,
            "shape": [g["n1"], g["n2"], D],
            "dtype": g["dtype"],
            "device_ms": g["device_ms"],
            "batched_shape": [gb["batch"], gb["n1"], gb["n2"], gb["d"]],
            "batched_ms": gb["ms"],
            "batched_device_ms": gb["device_ms"],
            "batched_plain_ms": gb["plain_ms"],
            "batched_bound_ms": gb["bound_ms"],
            "batched_max_abs_err": gb["max_abs_err"],
        },
        {
            "name": "radial_contractions",
            "route": "cuda",
            "source": "gptorch_tpu_torch/csrc/radial_contract.cu",
            "replaces": "gptorch_tpu/ops/gpr_fast.py:300",
            "launches": sum(p["radial_contractions"] for p in paths.values()),
            "launches_by_path": {k: p["radial_contractions"] for k, p in paths.items()},
            "max_abs_err": c["max_abs_err"],
            "max_rel_err": c["max_rel_err"],
            "ms": c["ms"],
            "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"],
            "library_ms": None,
            "shape": [c["n"], D, 1],
            "dtype": c["dtype"],
        },
        {
            "name": "gram_mvm",
            "route": "cuda",
            "source": "gptorch_tpu_torch/csrc/radial_mvm.cu",
            "replaces": "gptorch_tpu/ops/iterative.py:92",
            "launches": sum(p["gram_mvm"] for p in paths.values()),
            "launches_by_path": {k: p["gram_mvm"] for k, p in paths.items()},
            "max_abs_err": m9["max_abs_err"],
            "max_rel_err": m9["max_rel_err"],
            "ms": m9["ms"],
            "plain_ms": m9["plain_ms"],
            "bound_ms": m9["bound_ms"],
            "bound_by": m9["bound_by"],
            "library_ms": None,
            "shape": [IT_N, D, 9],
            "dtype": "float32",
            "k1_ms": mvm_rows["timed"][1]["ms"],
            "k1_bound_ms": mvm_rows["timed"][1]["bound_ms"],
            "k17_ms": mvm_rows["timed"][17]["ms"],
            "k17_bound_ms": mvm_rows["timed"][17]["bound_ms"],
        },
        {
            "name": "lowrank_contractions",
            "route": "cuda",
            "source": "gptorch_tpu_torch/csrc/lowrank_contract.cu",
            "replaces": "gptorch_tpu/ops/iterative.py:454",
            "launches": sum(p["lowrank_contractions"] for p in paths.values()),
            "launches_by_path": {k: p["lowrank_contractions"] for k, p in paths.items()},
            "max_abs_err": lr["max_abs_err"],
            "max_rel_err": lr["max_rel_err"],
            "ms": lr["ms"],
            "plain_ms": lr["plain_ms"],
            "bound_ms": lr["bound_ms"],
            "bound_by": lr["bound_by"],
            "library_ms": None,
            "shape": [IT_N, D, lr["r"]],
            "dtype": "float32",
            "r17_ms": lowrank_rows["timed"][17]["ms"],
            "r17_bound_ms": lowrank_rows["timed"][17]["bound_ms"],
        },
    ]}
    print(f"# torch {torch.__version__}, CUDA {torch.version.cuda}, peak device memory: serving "
          f"{serving['peak_mem_gb']:.1f} GB, training {training['peak_mem_gb']:.1f} GB, general training "
          f"{general_training['peak_mem_gb']:.1f} GB, observe loop {observe_loop['peak_mem_gb']:.1f} GB, svgp "
          f"training {svgp_training['peak_mem_gb']:.3f} GB, dkl {dkl['peak_mem_gb']:.3f} GB, zoo training "
          f"{zoo_training['peak_mem_gb']:.1f} GB, iterative training {iterative_training['peak_mem_gb']:.3f} GB, "
          f"gplvm {latent['gplvm']['peak_mem_gb']:.3f} GB, uncertain prediction "
          f"{latent['uncertain_prediction']['peak_mem_gb']:.2f} GB, vecchia {latent['vecchia']['peak_mem_gb']:.2f} "
          f"GB (their phases {latent_s:.1f} s), statespace {structured['statespace']['peak_mem_gb']:.3f} GB (n = "
          f"{SS_N_LONG}: {structured['statespace']['long']['peak_mem_gb']:.3f} GB), kronecker "
          f"{structured['kronecker']['peak_mem_gb']:.3f} GB, ski {structured['ski']['peak_mem_gb']:.3f} GB (their "
          f"phases {structured_s:.1f} s), ensemble {fleet['ensemble']['peak_mem_gb']:.3f} GB, multioutput "
          f"{fleet['multioutput']['peak_mem_gb']:.3f} GB, derivative {fleet['derivative']['peak_mem_gb']:.3f} GB, exact "
          f"variants {fleet['exact_variants']['peak_mem_gb']:.3f} GB (their phases {fleet_s:.1f} s), heteroscedastic "
          f"{variants['heteroscedastic']['peak_mem_gb']:.3f} GB, deep {variants['deep']['peak_mem_gb']:.3f} GB, streaming "
          f"{variants['streaming']['peak_mem_gb']:.3f} GB, pathwise {variants['pathwise']['peak_mem_gb']:.3f} GB (their "
          f"phases {variants_s:.1f} s), bayesopt {apps['bayesopt']['peak_mem_gb']:.2f} GB, bayesopt_loop "
          f"{apps['bayesopt_loop']['peak_mem_gb']:.3f} GB, design {apps['design']['peak_mem_gb']:.2f} GB, metrics "
          f"{apps['metrics']['peak_mem_gb']:.3f} GB, kernel_search {apps['structure']['peak_mem_gb']:.3f} GB (their "
          f"phases {apps_s:.1f} s), mcmc_fused {mc['fused']['peak_mem_gb']:.2f} GB (the mcmc phases {mc_s:.1f} s), the "
          f"examples {examples_s:.1f} s (card vs CPU {examples['card_vs_cpu']}); "
          f"launches count each captured step's recorded launches once per "
          f"replay; total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps(kernels_line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--zoo-cpu-reference"]:
        sys.exit(zoo_cpu_reference(sys.argv[2]))
    if sys.argv[1:2] == ["--iterative-cpu-reference"]:
        sys.exit(iterative_cpu_reference(sys.argv[2]))
    if sys.argv[1:2] == ["--examples-cpu-reference"]:
        sys.exit(examples_cpu_reference(sys.argv[2]))
    if sys.argv[1:2] == ["--profiling-check"]:
        sys.exit(profiling_check(sys.argv[2]))
    if sys.argv[1:2] == ["--compare-side"]:
        sys.exit(compare_side(sys.argv[2] if len(sys.argv) > 2 else os.path.dirname(os.path.abspath(__file__))))
    try:
        sys.exit(main())
    except CheckFailed as exc:
        print(f"chip_smoke: check failed: {exc}", file=sys.stderr)
        sys.exit(1)
