#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``elfi_tpu_torch``) on one GPU.

    python3 chip_smoke.py

runs on cuda:0 and writes a profiler table of each graph to build/profiles/.
Every profile goes through ``utils.profiling.recorded`` (its recording
starts after a warm-up step) and fails its phase unless each of its host
launches has its device record.

Phases, each of which raises on failure (exit code != 0):

1. Require a CUDA device; print its name, its power limit and the CUDA
   version PyTorch was built with.
2. Build the hand-written kernels from ``elfi_tpu_torch/csrc/`` with nvcc,
   one nvcc process per kernel, all started together.
3. Hold the MA2 distance kernel (K1) against its plain PyTorch version on
   the card: the same noise in both (max relative error <= 1e-5), the
   kernel's own Philox stream against ``torch.randn`` (mean and std of the
   distances within 0.02), the kernels' normals (Philox and
   ``box_muller_fast``, 2**20 x 102 values) against ``torch.randn``'s
   (mean and std within 1e-3, the 1e-4 and 1 - 1e-4 quantiles within 0.02)
   and the normal CDF (Kolmogorov-Smirnov distance < 3e-4), determinism per
   seed, the fused rejection loop
   against the batch-at-a-time loop (bit-identical), and the time per call
   of the kernel, the plain version and the top-N merge.
4. The main path on the plain MA2 graph: ``Rejection(ma2.get_model(...)
   ["d"], batch_size=2**17, device="cuda").sample(5000, n_sim=2048 *
   2**17)``, gated at |posterior mean - (0.6, 0.2)| < 0.05.
5. The same on the MA2 kernel graph (``models.ma2_kernel``) at batch 2**21;
   K1's launch count must equal the number of batches (every count here
   is ``ran``: launches by the host and inside replayed CUDA graphs).  Both graphs' merges
   must go through the cull kernel (``topn_cull``), counted on every path
   that merges.
5a. The merge (``phase_merge``, at most 30 s): (a) the cull kernel against
   its plain version, bit for bit (keys, index map, every column, the
   acceptance count), and both against the flat merge, on 41 merges at
   each of 2**17 and 2**21 rows, n 5000 (``merge_cases``: a fresh buffer,
   candidate counts just above and well above the width, at the edges of
   the kernel's counting sort, its copies of every tile and its one-pass
   capacity, each minus one, equal and plus one, exact ties at the N-th
   key, NaN and +inf distances, a threshold rejecting everything, a partly
   +inf buffer, a 2-D distance under a vector threshold, an int64
   ``__pos`` and a (B, 2) column); (b) the fused MA2 rejection on both
   graphs at the main path's point under the chosen merge settings equal
   to the flat merge with no unroll, gated, its quantile-mode loop under
   ``torch.cuda.set_sync_debug_mode("error")``; (c) the kernel's time at
   n/16, 4096, 16384 and 32768 candidates (queued ahead and with the
   host's queueing), its plain version's, the flat merge's and
   ``torch.topk``'s at 2**21, its device time by kernel and its device
   operations a merge (at most two, no memset) from one profile, the
   host's time to queue a merge, and the MA2 kernel graph's busy share
   from one profiled run.
6. Hold the g-and-k distance kernel (K2) against its plain version: the
   same normals at 2**16 and 2**21 simulations and n_obs 17, 50 and 64
   (max relative error <= 1e-5), its sorting network against
   ``torch.sort`` (exactly equal, +inf pads included), its own stream
   against ``torch.randn`` (mean and median within 15 %), determinism per
   seed, and the time per call of the kernel, its plain version and the
   merge at 2**21.
7. The main path on both g-and-k graphs (``models.gnk`` and
   ``models.gnk_kernel``): ``sample(5000, n_sim=2**26)`` at batch 2**21
   and n_obs 50, gated at (0.1, 0.1, 0.5, 0.05) from the JAX package's
   posterior means for the same call; K2 must run 32 times on the kernel
   graph and never on the plain one.
7a. The observed data (``phase_observed``, at most 60 s): every zoo
   model's observed data generated on the card through ``get_model``'s
   default device from the Threefry streams (``utils/threefry.py``),
   against the port's CPU result and, at every setting of
   ``elfi_tpu_torch/models/data/*_observed.npz``, against the JAX
   package's array (equal for Ricker, Lotka-Volterra and daycare, whose
   event loop sums in XLA's CPU order; within 1e-6 of the scale for the
   linear models, 1e-5 for the nonlinear recursions, 1e-2 absolute for
   Lorenz-96); Lotka-Volterra's two settings at 50 observations are left
   out (about 10 s each at batch 1); one setting of each model that no
   file holds against the CPU.  Then MA2 rejection on
   the K1 graph at ``seed_obs=1`` (2**28 simulations at 2**21, 5000
   samples) within 0.01 of the JAX package's posterior means for the same
   call, and g-and-k on the K2 graph at ``seed_obs=4`` (2**26 at 2**21)
   within phase 7's gate of the JAX means; K1 128 and K2 32 launches.
8. The adaptive distance: g-and-k octiles with ``AdaptiveDistance``, batch
   2**16, ``sample(1000, n_sim=2**20)``; two weight vectors, the second
   finite and positive, sorted finite 1-D distances, one seed giving one
   result, posterior means inside the prior.
9. SMC proposals on the card: ``SMC.prepare_new_batch(i)`` of a round
   whose mixture is wide enough to force prior-support redraws, against a
   proposal builder made afresh from the same population, bit for bit; then
   ``SMC(...).sample(100, quantiles=[0.2])`` fused and batch at a time on
   both MA2 graphs, bit for bit.
10. SMC on gauss2d at the JAX bench's operating point
   (``bench.py:_bench_smc_gauss2d``): ``SMC(m["d"], batch_size=16384,
   seed=4).sample(2000, thresholds=[2.0, 1.0, 0.5, 0.3])`` after a warm-up
   with seed 3, gated at |weighted posterior mean - observed sample mean|
   < 0.05 per dimension; wall seconds, simulations, simulations per second
   and batches per round.
11. SMC on both MA2 graphs at the JAX accuracy gate's settings (batch
   2000, seed 3, ``sample(500, quantiles=[0.25] * 3)``), gated at 0.05
   from (0.6, 0.2); K1 must run once per batch of all rounds on the kernel
   graph and never on the plain one.
12. ``AdaptiveThresholdSMC`` and ``AdaptiveDistanceSMC`` on the plain MA2
   graph at the JAX gate's settings, gated at 0.05; the density-ratio fit
   must have run on the card.
13. Profile a few batches of each rejection graph and the whole gauss2d SMC
   run: device busy share of the wall time and the time by kernel (the top
   five printed, the table written).
14. BSL at the JAX bench's operating point (``bench.py:_bench_bsl_ma2``)
   with no ``device=`` and no backend set: ``BSL(ma2.get_model(
   seed_obs=271), n_sim_round=500, likelihood=standard_likelihood(
   shrinkage="warton", penalty=0.3), seed=4).sample(1000, burn_in=200,
   ...)`` after a warm-up with seed 3, its fused loop under
   ``torch.cuda.set_sync_debug_mode("error")``, gated at |chain mean -
   (0.6, 0.2)| < 0.1 with an acceptance rate in (0.05, 1); one chain per
   seed; launches and device time per step from two profiled chains
   (table written), the busy share, and neither distance kernel launched;
   then the JAX package's ``TestFusedBSL`` point fused and on the host
   (means within 0.15), the unbiased estimator fused and the robust
   ('mean') host chain.
14a. The CUDA graphs (``phase_capture``, at most 150 s; every path above
   already runs captured): in one process each path run eagerly
   (``utils.capture._ENABLED = False``) and captured, held equal bit for
   bit -- MA2 rejection on both graphs, with a threshold and without, the
   g-and-k kernel graph, gauss2d SMC and MA2 SMC on the kernel graph, the
   BSL chain, ``CompiledProgram.jitted`` against ``traceable`` -- with, per
   mode, the wall, device ms and busy share, the host launches a chunk
   (two profiled runs differenced), the captures and the kernels'
   launches inside graphs; K1 and K2 keyed from device memory against
   the value path, and 20 launches of each inside one graph against 20
   eager ones, in turns.
15. BOLFI at the JAX bench's Ricker point (``bench.py:_bench_bolfi_ricker``)
   with no ``device=``: a rejection ground truth over 2**22 simulations
   (batch 2**17, seed 9) within 0.25 SDs of the JAX package's means for the
   same call; ``BOLFI(m["log_d"], initial_evidence=40, update_interval=20,
   ...).fit(500)`` then ``sample(1000, n_chains=4)`` after a warm-up with
   seed 2, timed with seed 1, its fused segments under
   ``torch.cuda.set_sync_debug_mode("error")``, each posterior mean within
   2 ground-truth SDs; one captured descent replayed per acquisition, refit
   and fit; seed 1 twice equal; the fit and sample walls, launches and
   device ms per acquisition, refit and NUTS iteration (profiles written),
   the mean tree depth, ESS, R-hat and the busy share; one refit eager and
   replayed, equal bit for bit; then the JAX accuracy gate's MA2 point
   (seed 5, 24 -> 120 evidence, 4 x 1200 NUTS) within 0.15 of (0.6, 0.2),
   the host loop to 40 with a finite threshold and ``x_min`` in the box,
   and neither distance kernel launched.
16. BOLFIRE at the JAX bench's g-and-k point (``bench.py:_bench_bolfire_gnk``)
   with no ``device=``: a rejection ground truth over 2**20 simulations
   (batch 2**14, seed 8) within (0.1, 0.1, 0.5, 0.05) of the JAX package's
   means for the same call; ``BOLFIRE(m, n_training_data=2000,
   feature_names=["ss_osq"], n_initial_evidence=40, update_interval=10,
   acq_noise_var=0.25, ...).fit(200)`` then ``sample(1000, n_chains=4)``
   after a warm-up with seed 2, timed with seed 1, its fused segments under
   ``torch.cuda.set_sync_debug_mode("error")``, gated as the bench gates it
   (A within 1.0 of the ground truth, A's posterior sd below 0.8 of the
   prior's, every mean finite and in [0, 10]); seed 1 twice equal; the fit
   and sample walls, launches, device and wall ms of the initial run, an
   acquisition, a classifier round and a refit, and per NUTS iteration
   (profiles written), the busy share; the JAX test points (g-and-k fused
   and on the host, MA2 with its triangle prior) finite and in bounds with
   12 classifier attributes; neither distance kernel launched.
17. The variance acquisitions: BOLFI's host loop on MA2 from 10 to 25
   evidence with each of ``MaxVar``, ``RandMaxVar`` and ``ExpIntVar``
   (grid) through ``acquisition_method=``, with no ``device=``: the
   evidence in the bounds, the GP finite and on the card, and the wall of
   one more acquisition of each.
18. ROMC at the JAX bench's g-and-k point (``bench.py:_bench_romc_gnk``)
   with no ``device=``: the ground truth of phase 16; ``ROMC(m["d"],
   bounds=[(0, 10)] * 4, seed=5).solve_problems(n1=50, seed=6)``,
   ``estimate_regions(eps_filter=compute_eps(0.5))``, ``sample(n2=20,
   seed=7)`` after a warm-up with seeds (2, 3, 4); the bench's gate
   (weighted means within (0.3, 0.3, 1.5, 0.15) of the ground truth) held
   on the mean over 12 seed triples, the bench's first, and that mean
   within half the tolerance of the JAX package's over the same triples;
   the walls of the solve, the regions and the sample; the run repeated,
   equal; launches and device ms per Adam step, per line-search iteration
   and per Hessian (tables written), and the busy share from them; the
   JAX accuracy gate's MA2 point within 0.1 of (0.6, 0.2);
   neither distance kernel launched.
19. The zoo, with no ``device=``: ``Rejection(m["d"], batch_size=...,
   seed=1).sample(...)`` on each model at its ``get_model`` defaults, the
   published sizes (AR(1), ARCH, M/G/1 and the stochastic volatility model
   at 2**16 a batch over 2**18 simulations, Lorenz-96 at 2**16 over 2**17,
   toad at 2**14 over 2**15, 256 samples each; Lotka-Volterra at 2**15 and
   daycare at 2,048 (29 x 53 x 33), one batch and 64 samples; the scratch
   assay on the host, two batches of 8).  Gates: (a) each device model's
   summary statistics at its true parameters (N simulations) within 4
   combined standard errors of the JAX package's means from the CPU; (b)
   the cheap models' posterior means within 4 sqrt(sd_jax^2 + sd_port^2)
   of the JAX package's mean for the same call, the sds over seeds 1-5 on
   the CPU; (c) every sample finite and inside the prior; (d) neither
   distance kernel launched.  Per model the wall, sims/s, a batch's device
   ms and busy share, and for Lotka-Volterra and daycare the steps and the
   launches and device ms per step (a short-horizon batch profiled).
20. The host executor: a scipy prior, a device simulator, a host summary
   and a device distance through ``Rejection`` (2**17 simulations, mean
   within 0.1 of the observed 1.2) and ``Model.generate``; BDM with its C++
   simulator built by ``ensure_executable`` into a temporary directory.
21. Output pools, with no ``device=``: ``Rejection(m["d"],
   batch_size=2**21, seed=11, pool=OutputPool(["t1", "t2", "d"]))
   .sample(5000, n_sim=16 * 2**21)`` on the MA2 kernel graph launches K1
   16 times and equals a pool-less batch-at-a-time run bit for bit; the
   same call again replays the pool (K1 0 times, no prior draw, equal);
   ``n_sim=24 * 2**21`` launches K1 8 more times (24 batches pooled);
   ``fused=True`` with a pool raises.  Walls and sims/s of each run, the
   pool's copy off the card per batch (host clock, and the DtoH device time
   of one profiled batch holding exactly one K1 kernel), a stored batch's
   copy back.  An ``ArrayPool`` of
   the plain graph's t1, t2 and simulations (2**17 x 8) saved, opened and
   replayed through a model with a cityblock distance on the same node
   names: no simulator call, equal to that model's own run; deleted.
22. Persistence and the aux modules: the MA2 kernel model saved after a
   run on the card (no CUDA tensor in the pickle) and loaded, equal samples
   at the same seed; ``adjust_posterior`` on a plain-graph sample (2**21
   simulations) within 0.1 of (0.6, 0.2); ``compare_models``;
   ``TwoStageSelection`` of the lag-1 and lag-2 autocovariances at 2**20
   simulations, the simulator run once a batch (the other candidates
   replay its pool); a ``Testbench`` of two repetitions; a
   ``utils.profiling.trace`` of one batch holding its ``annotate`` name and
   a device record for each of its host launches; matplotlib never
   imported.
23. The eleven distributions on the card: 2**22 draws each from a CUDA
   generator, mean and variance within 5 standard errors of scipy's
   (cauchy: the quartiles), a KS distance under 1.5e-3; ``logpdf``,
   ``cdf`` and ``ppf`` at 4096 points on the card equal to the CPU (rtol
   1e-5, atol 1e-6; 1e-4 and 1e-5 on betainc or a bisection).  The
   gamma/beta prior model of ``scripts/torch_prior_reference.py``: a
   device graph with its ``ModelPrior`` on the card, rejection at 2**20 a
   batch and SMC, posterior means within (0.01, 0.003) and (0.02, 0.006) of
   the JAX package's for the same calls.
24. The default device: ``Rejection(m["d"], batch_size=2**21,
   seed=1).sample(1000, n_sim=8 * 2**21)`` on the MA2 kernel graph with no
   ``device=`` anywhere and no backend set must run on cuda:0 through K1.
25. The backends beyond one device, in at most 60 s: (a) the device list
   ``ShardedBackend(["cuda:0", "cuda:0"])`` (and a list of one): fused
   MA2 kernel rejection over 16 batches of 2**21, MA2 kernel SMC at phase
   11's settings and a g-and-k kernel rejection over 4 batches of 2**21,
   each equal to native bit for bit with its kernel launched once a batch;
   ``nuts_chains`` on a standard normal, BSL at the ``TestFusedBSL`` point
   and ROMC at the 2-d MA2 test point over the list, each equal to the
   one-device run; (b) ``MultiprocessingBackend(4)``: one probe task of
   each graph on every worker (its parts: compiling the shipped program
   for the CPU, the first run, a warm run, a fresh copy), then the
   all-host graph of ``scripts/torch_host_graph.py`` (32 batches) equal
   to native on the card, the MA2 plain graph (64 batches) equal to
   native on the CPU, sims/s both ways; (c)
   ``ClusterBackend`` on the card: with no worker the MA2 kernel graph
   runs locally through K1; two ``python -m elfi_tpu_torch.worker``
   processes give the native samples of the all-host graph, and its
   batches stay equal when one worker is killed mid-run (the time until
   its batch is back); (d) ``MultihostBackend``: two processes of this
   script (``--multihost-rank``) on cuda:0 over gloo, the MA2 kernel graph
   batch at a time, both equal to the one-process run, each launching K1
   for its own 4 batches.  The helpers start after (a)'s timed runs, and
   the ranks wait for the others to finish before they touch the card.

Phase 2 also reads ``ptxas -v`` for every kernel instance and fails on a
spill store, a spill load or a stack frame.  Each kernel's ``bound_ms`` is
the least time the card could take for its work at 2**21 simulations (see
``bound_ms`` below).

The last two lines are a JSON object describing each kernel and a JSON
object ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import time
import functools
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from pathlib import Path

import numpy as np
import torch

TRUE_PARAMS = np.array([0.6, 0.2])
GATE = 0.05
SEED_OBS = 271
N_SAMPLES = 5000
N_SIM = 2048 * 2**17
PLAIN_BATCH = 2**17
KERNEL_BATCH = 2**21
N_OBS = 100
OUT_DIR = Path(__file__).resolve().parent / "build" / "profiles"

# g-and-k: scripts/gnk_ab.py's operating point (n_obs 50, 32 batches of
# 2**21), on the observed sample of seed_obs=1
GNK_BATCH = 2**21
GNK_N_SIM = 2**26
GNK_N_OBS = 50
GNK_SEED_OBS = 1
GNK_NAMES = ("A", "B", "g", "k")
GNK_GATE = np.array([0.1, 0.1, 0.5, 0.05])
# Posterior means (A, B, g, k) of the JAX package for the same call, on the
# CPU:  python -c 'import jax; jax.config.update("jax_platforms", "cpu");
#   import elfi_tpu as elfi; from elfi_tpu.models import gnk;
#   m = gnk.get_model(n_obs=50, seed_obs=1);
#   r = elfi.Rejection(m["d"], batch_size=2**21, seed=1).sample(
#       5000, n_sim=2**26, bar=False);
#   print([float(r.samples[k].mean()) for k in "ABgk"])'
GNK_JAX_MEANS = np.array([3.417664051055908, 1.4710832834243774,
                          4.9136834144592285, 0.509651243686676])

# SMC: the JAX bench's gauss2d phase (bench.py:_bench_smc_gauss2d) and the
# JAX accuracy gates' MA2 settings (tests/functional/test_inference.py)
GAUSS_KW = dict(n_obs=50, true_params=[4.0, 2.0], nd_mean=True,
                cov_matrix=np.eye(2))
GAUSS_BATCH = 16384
GAUSS_N = 2000
GAUSS_THRESHOLDS = [2.0, 1.0, 0.5, 0.3]
SMC_BATCH = 2000
# BSL: the JAX bench's ma2_bsl phase (bench.py:_bench_bsl_ma2)
BSL_N = 1000
BSL_N_SIM_ROUND = 500
BSL_BURN_IN = 200
BSL_SAMPLE_KW = dict(sigma_proposals=np.diag([.05, .05]),
                     params0=np.array([[.6, .2]]), burn_in=BSL_BURN_IN,
                     bar=False)
BSL_GATE = 0.1
BSL_PROFILE_STEPS = 20
# BOLFI: the JAX bench's Ricker phase (bench.py:_bench_bolfi_ricker) and the
# JAX accuracy gate's MA2 point (tests/functional/test_inference.py:88-105)
RICKER_BOUNDS = {"t1": (3, 5), "t2": (0.05, 0.8), "t3": (4, 16)}
RICKER_NOISE = {"t1": 0.01, "t2": 0.0015, "t3": 0.36}
RICKER_FIT = dict(batch_size=1, initial_evidence=40, update_interval=20,
                  bounds=RICKER_BOUNDS, acq_noise_var=RICKER_NOISE)
RICKER_N_EVIDENCE = 500
RICKER_N_SAMPLES = 1000
RICKER_GT_BATCH = 2**17
RICKER_GT_N_SIM = 2**22
# Rejection ground truth of the JAX package for the same call, on the CPU:
#   python -c 'import jax; jax.config.update("jax_platforms", "cpu");
#   (bench.py's Ricker model m, observed series of key 4);
#   gt = elfi.Rejection(m["d"], batch_size=2**17, seed=9).sample(
#       2000, n_sim=2**22, bar=False)' -> means and population SDs
RICKER_JAX_GT_MEANS = np.array([4.072978973388672, 0.41394490003585815,
                                9.150758743286133])
RICKER_JAX_GT_SDS = np.array([0.3053286075592041, 0.20189444720745087,
                              0.8837023377418518])
# the port's ground truth against the JAX package's, in JAX ground-truth SDs
RICKER_GT_GATE = 0.25
RICKER_GATE_SDS = 2.0
BOLFI_MA2_FIT = dict(batch_size=1, initial_evidence=24, update_interval=12,
                     bounds={"t1": (-2, 2), "t2": (-1, 1)}, acq_noise_var=0.1)
BOLFI_MA2_GATE = 0.15
NUTS_PROFILE_ITERS = 10
# BOLFIRE: the JAX bench's g-and-k phase (bench.py:_bench_bolfire_gnk)
BOLFIRE_FIT = dict(n_training_data=2000, batch_size=2000,
                   feature_names=["ss_osq"],
                   bounds={p: (0.0, 10.0) for p in GNK_NAMES},
                   n_initial_evidence=40, update_interval=10,
                   acq_noise_var=0.25)
BOLFIRE_N_EVIDENCE = 200
BOLFIRE_N_SAMPLES = 1000
BOLFIRE_GT_BATCH = 2**14
BOLFIRE_GT_N_SIM = 2**20
# The JAX package's rejection ground truth for the same call
# (bench.py:268-270: batch 2**14, 2**20 sims, 1000 samples, seed 8), as
# BENCH_r05.json records it (gnk_bolfire, ground_truth_rejection_means)
BOLFIRE_JAX_GT_MEANS = np.array([3.43, 1.498, 5.205, 0.525])
# the bench's gate (bench.py:290-294): A within 1.0 of the ground truth and
# A's posterior sd below 0.8 of the prior's
BOLFIRE_A_GATE = 1.0
BOLFIRE_SD_SHARE = 0.8
BOLFIRE_PROFILE_ROUNDS = 10
# the variance acquisitions: BOLFI's host loop on MA2 from 10 initial points
VAR_ACQ_N_EVIDENCE = 25
# ROMC: the JAX bench's g-and-k phase (bench.py:_bench_romc_gnk): ROMC(seed),
# solve_problems(n1, seed), estimate_regions(compute_eps(0.5)),
# sample(n2, seed), gated at (0.3, 0.3, 1.5, 0.15) from the ground truth
ROMC_N1 = 50
ROMC_N2 = 20
ROMC_QUANTILE = 0.5
ROMC_SEEDS = (5, 6, 7)
ROMC_WARMUP_SEEDS = (2, 3, 4)
ROMC_GATE = np.array([0.3, 0.3, 1.5, 0.15])
# One triple's weighted means scatter widely at n1 = 50 (sd about 0.1, 0.15,
# 0.45, 0.06 over triples) and fail the bench's gate on about a third of
# triples in either package (scripts/torch_romc_seeds.py: the JAX package 8
# of 12 on the CPU, the port 9 of 12).  So the gate is held on the mean
# over 12 triples, k = 0..11: (5 + 3k, 6 + 3k, 7 + 3k), the bench's first;
# and that mean must be within half the bench's tolerance of the JAX
# package's mean over the same triples (scripts/torch_romc_seeds.py --jax,
# on the CPU).
ROMC_SWEEP_TRIPLES = 12
ROMC_JAX_SWEEP_MEANS = np.array([3.4544370667931372, 1.672933177074042,
                                 4.083796503696271, 0.4644597375845316])
ROMC_PARITY = ROMC_GATE / 2
ROMC_PROFILE_STEPS = 10
# the JAX accuracy gate's MA2 point (tests/functional/test_inference.py:
# 115-120): seed_obs 271, ROMC seed 7, n1 60 with seed 8, eps 0.1, n2 30
# with seed 9, weighted means within 0.1 of (0.6, 0.2)
ROMC_MA2 = dict(seeds=(7, 8, 9), n1=60, eps=0.1, n2=30, gate=0.1)

# The zoo (phase 20): every model at its get_model defaults, the published
# sizes.  Rejection batch per model; the cheap models run n_sim =
# ZOO_N_SIM and keep N_SAMPLES = 256 (scripts/torch_zoo_reference.py), the
# event-loop models one batch and 64 samples, the host models two batches.
ZOO_BATCH = {"ar1": 2**16, "arch": 2**16, "mg1": 2**16,
             "stochastic_volatility": 2**16, "lorenz": 2**16, "toad": 2**14,
             "lotka_volterra": 2**15, "daycare": 2048, "scratch_assay": 8}
ZOO_SEED = 1
ZOO_GATE_SE = 4.0
ZOO_GATE_SD = 4.0
# Gate (a): the JAX package's mean and standard error of each gate
# statistic (torch_zoo_reference.gate_stats) at the get_model true
# parameters, from N_SUMMARY simulations on the CPU:
#   python3 scripts/torch_zoo_reference.py summaries
ZOO_JAX_SUMMARIES = {
    "ar1": (
        [-0.011788000354599482, 5.149075347044005],
        [0.021839530757965648, 0.05059468516006834]),
    "arch": (
        [0.004150490718132005, 0.6886697802110575, 0.25824486047241635, 0.05392279500337338, 0.0005309294835456058, -0.015652501617950065, -0.008868210767566609, 0.023205170911347217, 0.002538392551148405, -0.002629319108041983, -0.0030749055650378665, 0.008617561337898039, 0.001530393817223974, -0.0008220684018479529, 0.0063282252483558565, 0.001165000970643204, 0.005233261082543239],
        [0.003467459464049825, 0.0164611188293618, 0.004807950103168591, 0.004372216179338408, 0.00389033084439825, 0.0035783785577036455, 0.0032781729046079343, 0.0016271764607448465, 0.001269983719240754, 0.001134195434196873, 0.0010058414574977948, 0.0007018541437327649, 0.0005608923124331555, 0.0005162883672180355, 0.000550392070235564, 0.0003995517948174576, 0.0004151074944670952]),
    "mg1": (
        [1.7104035017546266, 2.2543686300050467, 2.770847002742812, 3.267002454958856, 3.7486943744588643, 4.217723822686821, 4.77674973080866, 5.670320576056838, 7.352561467792839, 10.503334959968925],
        [0.008055546030642086, 0.010423210371269158, 0.011348144527350874, 0.012045017678661563, 0.012463091188696105, 0.013305327319041098, 0.019842259407198217, 0.034268648037111375, 0.052493092235128734, 0.07448990377974873]),
    "stochastic_volatility": (
        [4.5195082920836285, 0.3538995722888103],
        [0.05650094898517376, 0.007788257075080845]),
    "lorenz": (
        [2.245976648526266, 10.890869132243097, 10.795031466521323, 1.1021167319850065, 1.769897200516425, 0.43407281394291886],
        [0.002871142185389863, 0.009561439487866186, 0.009470940624707748, 0.007830471530802786, 0.008728168650763408, 0.007103957447763678]),
    "toad": (
        [977.7724609375, 50.6436348259449, 1.9324345675995573, 1.9808407904347405, 2.052614896092564, 2.15461145946756, 2.2945367672946304, 2.4895504924934357, 2.767532598460093, 3.191121926996857, 3.8928726254962385, 7.411795781925321, 849.072265625, 62.29971665516496, 2.185663890093565, 2.230232240865007, 2.304669932113029, 2.4074345105327666, 2.5459572509862483, 2.7326936218887568, 2.994687292026356, 3.375680306693539, 4.003969156648964, 7.403145795688033, 777.6279296875, 66.66552152857184, 2.2565378847066313, 2.302720056613907, 2.3826251460704952, 2.489874486811459, 2.6367716724053025, 2.835103778867051, 3.0972482811193913, 3.473383149364963, 4.0823760950006545, 7.3969278945587575, 701.0947265625, 67.41051433607936, 2.2688987725414336, 2.3178378944285214, 2.3935957732610404, 2.502558903535828, 2.65028580930084, 2.8486680353526026, 3.115049014100805, 3.4884204315021634, 4.101836099755019, 7.391362693626434],
        [1.3195802602376012, 0.051884472953255906, 0.00241114678669423, 0.0024975918563835153, 0.0024731232429690683, 0.0025080168981900693, 0.002530704526161006, 0.002562563470811715, 0.0028501963378537, 0.00323802570157892, 0.003873524879511235, 0.023954970866390878, 1.3442349955165944, 0.07829406877096254, 0.0026458493747527163, 0.0026123270787992074, 0.002677097422986461, 0.0024972063330647716, 0.0026091666835024075, 0.0027913622129710014, 0.003038990251083764, 0.0032318297457331717, 0.00433822163004059, 0.024131189464680593, 1.3772133366523271, 0.09435809266981482, 0.0026151935998245494, 0.002689804934882911, 0.0027239060712011117, 0.002621896380418887, 0.00283558879120786, 0.0029343121550526197, 0.0031492007199767614, 0.0034028364109331753, 0.0043842082056397575, 0.024210142034677116, 1.2747720313767124, 0.09744238808626018, 0.0026663479027436137, 0.002705425649191088, 0.0027882754053674746, 0.002733180062608008, 0.00282816135792112, 0.0029596882820272217, 0.00324647431023071, 0.003416920040792981, 0.004484928381366479, 0.024374621209405232]),
    "lotka_volterra": (
        [118.0951560139656, 187.69795817136765, 9.288876093924046, 9.806665439158678, 0.817292618798092, 0.8490008544176817, 0.45551098976284266, 0.5274098652880639, 0.02919601711548836],
        [0.7624819650500775, 0.9487179785027756, 0.03571036530954518, 0.035459301869535526, 0.001649668662255132, 0.0015629702556352496, 0.003040073624161616, 0.0030433833252668, 0.003848616555716694]),
    "daycare": (
        [2.7259451033354822, 18.63523706896551, 0.8672062144293612, 0.19284677676202175],
        [0.001675261608244517, 0.02557895147475422, 0.0006451592134853718, 0.000831647986424468]),
}
# Gate (b): the JAX package's rejection posterior means at the smoke's
# call (n_sim, 256 samples, the get_model observed data), the mean over
# seeds 1-5 and the sd over them, and the port's sd over the same seeds on
# the CPU (batch 2**14 on the CPU, the same call otherwise):
#   python3 scripts/torch_zoo_reference.py rejection
#   python3 scripts/torch_zoo_reference.py rejection --port
# A model's means pass within ZOO_GATE_SD * sqrt(sd_jax^2 + sd_port^2).
ZOO_JAX_REJECTION = {
    "ar1": dict(mean=[0.6997177481651307],
                  sd_jax=[0.008317752735945788],
                  sd_port=[0.007235079702178458]),
    "arch": dict(mean=[0.667242431640625, 0.7548308968544006],
                   sd_jax=[0.011764815551492898, 0.010569300844755141],
                   sd_port=[0.00892307017740959, 0.005875437468252606]),
    "mg1": dict(mean=[2.3301762104034425, 2.302656078338623, 0.1772923231124878],
                  sd_jax=[0.13670448545249886, 0.19369188730552017, 0.0011145658148814983],
                  sd_port=[0.040815640643117455, 0.07193723229573011, 0.001539830364239384]),
    "stochastic_volatility": dict(mean=[1.1645991325378418, 0.4511938691139221],
                                    sd_jax=[0.017134473159322528, 0.01577893264650797],
                                    sd_port=[0.008620200958370041, 0.016278315452658523]),
    "lorenz": dict(mean=[1.8060012817382813, 0.1225844830274582],
                     sd_jax=[0.03100314582243135, 0.004156745325269486],
                     sd_port=[0.024525741437768585, 0.0031080939788180042]),
    "toad": dict(mean=[1.6620054483413695, 43.42133255004883, 0.6155507802963257],
                   sd_jax=[0.01953859267697256, 0.4654487514044549, 0.0024340760520443028],
                   sd_port=[0.008969244370053366, 0.43261259692907084, 0.002890023742057926]),
}

# Pools, persistence, the aux modules and the distributions.  The pool
# phase runs the MA2 kernel graph at the main path's batch: 16 batches
# pooled, replayed, then extended to 24; an ArrayPool of the plain graph's
# simulations at 2**17 a batch for 8 batches.
POOL_SEED = 11
POOL_BATCHES = 16
POOL_EXTRA = 8
ARRAY_POOL_BATCHES = 8
AUX_N_SIM = 2**20
AUX_GATE = 0.1          # |adjusted posterior mean - (0.6, 0.2)| at 2**21 sims
DIST_DRAWS = 2**22
DIST_POINTS = 4096
DIST_SE = 5.0           # draws' mean and variance within 5 SEs of scipy's
DIST_KS = 1.5e-3        # KS distance of 2**22 draws to scipy's cdf
DIST_TOL = (1e-5, 1e-6)  # the card against the CPU: rtol, atol ...
DIST_TOL_LOOSE = (1e-4, 1e-5)  # ... and for functions on betainc or a
                               # bisection
DIST_CASES = [
    ("lognorm", (0.5, 0.0, 2.0), (0.05, 8.0), ("logpdf", "cdf", "ppf")),
    ("gamma", (2.0, 0.0, 1.5), (0.01, 15.0), ("logpdf", "cdf", "ppf")),
    ("beta", (2.0, 5.0), (0.001, 0.999), ("logpdf", "cdf", "ppf")),
    ("binom", (20, 0.3), None, ("logpdf",)),
    ("poisson", (4.0,), None, ("logpdf",)),
    ("t", (10.0, 0.5, 2.0), (-8.0, 8.0), ("logpdf", "cdf", "ppf")),
    ("cauchy", (1.0, 2.0), (-20.0, 20.0), ("logpdf", "cdf", "ppf")),
    ("laplace", (0.5, 2.0), (-10.0, 10.0), ("logpdf", "cdf", "ppf")),
    ("chi2", (4.0,), (0.01, 20.0), ("logpdf", "cdf", "ppf")),
    ("skewnorm", (3.0, 0.2, 1.5), (-3.0, 6.0), ("logpdf", "cdf")),
    ("weibull_min", (1.5, 0.0, 2.0), (0.01, 8.0), ("logpdf", "cdf", "ppf")),
]
DIST_LOOSE = {("gamma", "ppf"), ("chi2", "ppf"), ("beta", "cdf"),
              ("beta", "ppf"), ("t", "cdf"), ("t", "ppf")}
# The gamma/beta prior model of scripts/torch_prior_reference.py: posterior
# means (a, b) of the JAX package for the same calls, on the CPU:
#   python3 scripts/torch_prior_reference.py --seeds 1
# The tolerances are about 4 sqrt(2) times the seed-to-seed sd of either
# package over seeds 1-3 (rejection 0.0012-0.0015 and 0.0002-0.0003, SMC
# 0.003 and 0.0008-0.0013; the same script with --port for the port's).
GB_JAX_MEANS = {"rejection": np.array([1.4957072734832764,
                                       0.2987924814224243]),
                "smc": np.array([1.495306380606196, 0.29821240630426016])}
GB_TOL = {"rejection": np.array([0.01, 0.003]),
          "smc": np.array([0.02, 0.006])}

# The card's rates for a kernel's bound, H100 SXM at its 1.98 GHz boost clock
# over 132 SMs: HBM bytes per second; thread operations per second through
# the issue slots (128 lanes per SM per clock, the lanes of the 67 TFLOP/s
# FP32 figure); and through the special-function units, which also convert
# to and from 64-bit types (16 per SM per clock).
HBM_BYTES_S = 3.35e12
ISSUE_OPS_S = 128 * 132 * 1.98e9
XU_OPS_S = 16 * 132 * 1.98e9
# Operations per piece of work, from the kernels' SASS (PERF.md, Findings):
# (all, of them on the special-function units).  A Philox4x32-10 call is 10
# rounds of two IMAD.WIDE.U32 and two three-way LOP3; a Box-Muller pair
# (box_muller_fast) two LOP3 and eight FP32 operations around MUFU.LG2,
# SQRT, SIN and COS; a g-and-k value two accurate expf (8 each), a log1pf
# (21), the IEEE divide's fast path (7), a copysign and twelve products and
# sums, without the branches around the slow paths.
PHILOX_CALL_OPS = (40, 0)
BOX_MULLER_OPS = (14, 4)
GNK_TRANSFORM_OPS = (57, 4)


def log(*args):
    print(*args, flush=True)


def card_line():
    """``name, power.limit`` of the card as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, warmup=3, reps=25):
    """Median device time of ``fn()`` in ms, each call between its own pair
    of CUDA events, after ``warmup`` untimed calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# cycles of the spin kernel that holds the card while the host queues a
# timed call (about 2.5 ms at the 1.98 GHz boost clock)
SPIN_CYCLES = 5_000_000


def queued_ms(fn, warmup=3, reps=25):
    """Median device time of ``fn()`` in ms with its launches queued ahead:
    a spin kernel holds the card while the host queues the start event,
    ``fn``'s launches and the end event, so the host's time between
    launches is not counted (``time_ms`` counts it, for a call that
    launches several kernels).  ``fn`` must not wait for the card."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def reset_counts(*fns):
    """Zero the launch counts of kernel wrappers (``utils.capture``)."""
    for fn in fns:
        fn.launches = fn.captured = fn.graph_launches = 0


def ran(fn):
    """Launches of ``fn``'s kernel on the card: by the host, and inside the
    CUDA graphs replayed (calls recorded by a capture run nothing)."""
    return fn.launches + fn.graph_launches


def ptxas_entries(build_log):
    """(function, registers, spill stores, spill loads, stack frame bytes)
    for every kernel in an ``nvcc -Xptxas=-v`` log."""
    out, name, frame = [], None, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            frame = tuple(int(v) for v in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and name and frame:
            out.append((name, int(m.group(1)), frame[1], frame[2], frame[0]))
            name = frame = None
    return out


def bound_ms(ops_per_sim, bytes_per_sim, sims):
    """The least time the card could take for ``sims`` simulations that
    each need ``ops_per_sim`` = (all operations, special-function ones) and
    move ``bytes_per_sim``: the larger of the bytes over HBM's rate and the
    operations over their pipes' rates; (ms, what bounds it)."""
    t_bytes = bytes_per_sim * sims / HBM_BYTES_S
    t_ops = max(ops_per_sim[0] * sims / ISSUE_OPS_S,
                ops_per_sim[1] * sims / XU_OPS_S)
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes > t_ops else "operations"


def k1_ops(n_obs):
    """K1's operations per simulation: Philox calls and Box-Muller pairs for
    n_obs + 2 normals, the filter (two products, two sums a value), the lag
    products (a product and a sum each) and their float32 blocks of 8
    (a conversion and a double sum each)."""
    n_w = n_obs + 2
    calls, pairs = math.ceil(n_w / 4), math.ceil(n_w / 2)
    blocks = math.ceil((n_obs - 1) / 8) + math.ceil((n_obs - 2) / 8)
    return (calls * PHILOX_CALL_OPS[0] + pairs * BOX_MULLER_OPS[0]
            + 4 * n_obs + 2 * (2 * n_obs - 3) + 2 * blocks,
            pairs * BOX_MULLER_OPS[1] + blocks)


def k2_ops(n_obs):
    """K2's operations per simulation: Philox calls and Box-Muller pairs for
    n_obs normals, n_obs transforms, the pruned network for n_obs rows (two
    min/max a comparator), the differences (three a row) and their float32
    blocks of 8."""
    from elfi_tpu_torch.ops.kernels.sort_network import network
    calls, pairs = math.ceil(n_obs / 4), math.ceil(n_obs / 2)
    blocks = math.ceil(n_obs / 8)
    return (calls * PHILOX_CALL_OPS[0] + pairs * BOX_MULLER_OPS[0]
            + n_obs * GNK_TRANSFORM_OPS[0] + 2 * len(network(n_obs))
            + 3 * n_obs + 2 * blocks,
            pairs * BOX_MULLER_OPS[1] + n_obs * GNK_TRANSFORM_OPS[1]
            + blocks)


def observed_autocovs(device):
    from elfi_tpu_torch.models import ma2
    y = torch.as_tensor(ma2.observed_data(seed_obs=SEED_OBS,
                                          device=device))[None]
    return torch.tensor([float(ma2.autocov(y)[0]),
                         float(ma2.autocov(y, lag=2)[0])],
                        dtype=torch.float32, device=device)


def prior_params(batch, device, seed):
    """(t1, t2) drawn from the MA2 priors on ``device``."""
    from elfi_tpu_torch.models.ma2 import CustomPrior1, CustomPrior2
    g = torch.Generator(device=device).manual_seed(seed)
    t1 = CustomPrior1.rvs(2.0, size=batch, generator=g)
    t2 = CustomPrior2.rvs(t1, 1.0, size=batch, generator=g)
    return t1.contiguous(), t2.contiguous()


def smc_proposal_params(batch, device):
    """(t1, t2) as the MA2 kernel graph's SMC hands them to K1: the columns
    of one ``_GMProposals`` batch, made contiguous as the graph's op
    makes them.  The mixture has 500 components at prior draws."""
    from elfi_tpu_torch.methods.samplers import _GMProposals
    from elfi_tpu_torch.methods.utils import GMDistribution
    from elfi_tpu_torch.model.extensions import ModelPrior
    from elfi_tpu_torch.models import ma2_kernel
    prior = ModelPrior(ma2_kernel.get_model(seed_obs=SEED_OBS),
                       device=device).traceable_logpdf()
    means = torch.stack(prior_params(500, device, seed=17), dim=1)
    proposal = GMDistribution.prepare(means, np.diag([0.05, 0.05]),
                                      device=device)
    cols = _GMProposals(("t1", "t2"), batch, prior, proposal, 23)(1)
    check(not cols["t1"].is_contiguous(), "proposal columns are not views")
    return (cols["t1"].to(torch.float32).contiguous(),
            cols["t2"].to(torch.float32).contiguous())


def normal_stats(x):
    """Mean, std, the 1e-4 and 1 - 1e-4 quantiles and the Kolmogorov-Smirnov
    distance to the standard normal CDF of the values of ``x``.  At 2^20 x
    102 values the sampling sigmas are about 1e-4 (mean), 7e-5 (std), 2.4e-3
    (each tail quantile) and 8e-5 (KS); a radius 1 % off moves the KS
    distance by 2.4e-3 and the tail quantiles by 0.037."""
    v = torch.sort(x.flatten()).values
    n = v.numel()
    cdf = torch.special.ndtr(v.double())
    i = torch.arange(n, dtype=torch.float64, device=v.device)
    ks = torch.maximum((i + 1) / n - cdf, cdf - i / n).max()
    return {"mean": float(x.mean()), "std": float(x.std()),
            "q1e-4": float(v[round(1e-4 * (n - 1))]),
            "q1-1e-4": float(v[round((1 - 1e-4) * (n - 1))]),
            "ks": float(ks)}


def phase_kernel_checks(device):
    """K1 against its plain version on the card, and the times per call."""
    from elfi_tpu_torch.ops import topk
    from elfi_tpu_torch.ops.kernels.ma2 import (ma2_distance,
                                                ma2_distance_noise,
                                                ma2_distance_reference,
                                                philox_normals)
    obs = observed_autocovs(device)
    result = {}

    # the kernels' own normals (Philox, box_muller_fast) against torch.randn
    # and the normal CDF, at limits a few sampling sigmas wide
    g = torch.Generator(device=device)
    z = philox_normals(2**20, N_OBS + 2, g.manual_seed(9))
    r = torch.randn(z.shape, generator=g.manual_seed(10), device=device)
    check(bool(torch.isfinite(z).all()), "box_muller_fast: not finite")
    sz, sr = normal_stats(z), normal_stats(r)
    log(f"normals of box_muller_fast {tuple(z.shape)}: {sz!r}; torch.randn: "
        f"{sr!r} (limits: mean and std 1e-3 from randn's, tail quantiles "
        f"0.02 from randn's, KS against the normal CDF 3e-4)")
    check(abs(sz["mean"] - sr["mean"]) < 1e-3
          and abs(sz["std"] - sr["std"]) < 1e-3,
          "box_muller_fast: mean or std disagrees with torch.randn")
    check(all(abs(sz[q] - sr[q]) < 0.02 for q in ("q1e-4", "q1-1e-4")),
          "box_muller_fast: a tail disagrees with torch.randn")
    check(sz["ks"] < 3e-4, "box_muller_fast: KS distance to the normal CDF")
    del z, r

    # the same noise in both: the kernel's arithmetic, exactly; at the
    # rejection batches on prior draws, and at the SMC batch (not a
    # multiple of the 256-thread block) on the columns of a proposal batch
    for batch in (2**16, KERNEL_BATCH, SMC_BATCH):
        if batch == SMC_BATCH:
            t1, t2 = smc_proposal_params(batch, device)
        else:
            t1, t2 = prior_params(batch, device, seed=batch)
        g = torch.Generator(device=device).manual_seed(11)
        noise = torch.randn((batch, N_OBS + 2), generator=g, device=device)
        d_k = ma2_distance_noise(t1, t2, obs, noise)
        d_p = ma2_distance_reference(t1, t2, obs, N_OBS, batch, noise=noise)
        torch.cuda.synchronize()
        err = (d_k - d_p).abs()
        max_abs = float(err.max())
        max_rel = float((err / d_p.abs()).max())
        log(f"K1 noise-injected B={batch}: max_abs_err={max_abs!r} "
            f"max_rel_err={max_rel!r} (tolerance rel 1e-5)")
        check(bool(torch.isfinite(d_k).all()), "K1 output not finite")
        check(max_rel <= 1e-5, f"K1 disagrees with its plain version: "
              f"max relative error {max_rel} > 1e-5")
        if batch == KERNEL_BATCH:
            result["max_abs_err"] = max_abs
            result["max_rel_err"] = max_rel
        del noise

    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)

    # the kernel's own Philox stream against torch.randn: statistics
    batch = 2**20
    t1 = torch.full((batch,), 0.6, device=device)
    t2 = torch.full((batch,), 0.2, device=device)
    d_k = ma2_distance(t1, t2, obs, n_obs=N_OBS, batch_size=batch,
                       generator=gen(0))
    d_p = ma2_distance_reference(t1, t2, obs, N_OBS, batch,
                                 generator=gen(1))
    stats = [float(x) for x in (d_k.mean(), d_p.mean(), d_k.std(),
                                d_p.std())]
    log(f"K1 RNG path B={batch}: mean kernel={stats[0]!r} plain={stats[1]!r}"
        f" std kernel={stats[2]!r} plain={stats[3]!r} (tolerance 0.02)")
    check(bool(torch.isfinite(d_k).all()), "K1 output not finite")
    check(abs(stats[0] - stats[1]) < 0.02, "K1 distance means disagree")
    check(abs(stats[2] - stats[3]) < 0.02, "K1 distance stds disagree")

    a = ma2_distance(t1, t2, obs, N_OBS, batch, generator=gen(3))
    b = ma2_distance(t1, t2, obs, N_OBS, batch, generator=gen(3))
    c = ma2_distance(t1, t2, obs, N_OBS, batch, generator=gen(4))
    check(torch.equal(a, b), "K1 is not deterministic for one seed")
    check(not torch.equal(a, c), "K1 gives the same output for two seeds")
    log("K1 determinism: same seed equal, different seed differs")

    # times per call at the kernel graph's batch
    t1, t2 = prior_params(KERNEL_BATCH, device, seed=5)
    g_k, g_p = gen(21), gen(22)
    result["ms"] = time_ms(lambda: ma2_distance(
        t1, t2, obs, N_OBS, KERNEL_BATCH, generator=g_k))
    result["plain_ms"] = time_ms(lambda: ma2_distance_reference(
        t1, t2, obs, N_OBS, KERNEL_BATCH, generator=g_p))
    log(f"K1 B={KERNEL_BATCH}: kernel {result['ms']!r} ms/call, plain "
        f"{result['plain_ms']!r} ms/call (median of 25, CUDA events)")

    # the top-N merge, the other per-batch cost of the rejection loop
    for batch in (PLAIN_BATCH, KERNEL_BATCH):
        t1, t2 = prior_params(batch, device, seed=7)
        out = {"d": ma2_distance(t1, t2, obs, N_OBS, batch,
                                 generator=gen(8)), "t1": t1, "t2": t2}
        bufs = topk.init_buffers(N_SAMPLES, out, "d")
        bufs, _ = topk.merge_core(bufs, out, math.inf, "d")
        ms = time_ms(lambda: topk.merge_core(bufs, out, math.inf, "d"))
        result[f"merge_ms_{batch}"] = ms
        log(f"top-N merge n={N_SAMPLES} B={batch}: {ms!r} ms/call")
    return result


def phase_fused_equals_batchwise(device):
    """The fused loop and the batch-at-a-time loop give the same samples on
    the card, for both graphs."""
    import elfi_tpu_torch as et
    from elfi_tpu_torch.models import ma2, ma2_kernel
    for mod in (ma2, ma2_kernel):
        m = mod.get_model(seed_obs=SEED_OBS)
        kw = dict(batch_size=2**14, seed=3, device=device)
        a = et.Rejection(m["d"], **kw).sample(500, n_sim=8 * 2**14,
                                              bar=False)
        b = et.Rejection(m["d"], **kw).sample(500, n_sim=8 * 2**14,
                                              bar=False, fused=False)
        for k in a.outputs:
            check(np.array_equal(a.outputs[k], b.outputs[k]),
                  f"{mod.__name__}: fused and batch-at-a-time differ in {k}")
    log("fused == batch-at-a-time on the card, both graphs")


def timed_sample(node, batch_size, n_samples, n_sim, device, seed=1):
    """One rejection run from ``node``; returns (sample, seconds)."""
    import elfi_tpu_torch as et
    rej = et.Rejection(node, batch_size=batch_size, seed=seed, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = rej.sample(n_samples, n_sim=n_sim, bar=False)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def check_sample(res, batch_size, name):
    n_batches = math.ceil(N_SIM / batch_size)
    d = res.outputs["d"]
    check(d.shape == (N_SAMPLES,), f"{name}: d has shape {d.shape}")
    check(bool(np.all(np.isfinite(d))), f"{name}: non-finite distances")
    check(bool(np.all(np.diff(d) >= 0)), f"{name}: distances not sorted")
    for k in ("t1", "t2"):
        check(res.samples[k].shape == (N_SAMPLES,), f"{name}: {k} shape")
        check(bool(np.all(np.isfinite(res.samples[k]))),
              f"{name}: non-finite {k}")
    check(res.n_sim == n_batches * batch_size, f"{name}: n_sim {res.n_sim}")
    means = res.sample_means_array
    err = np.abs(means - TRUE_PARAMS)
    log(f"{name}: posterior means {means.tolist()!r} |err| {err.tolist()!r}"
        f" threshold {float(d[-1])!r} (gate < {GATE})")
    check(bool(np.all(err < GATE)), f"{name}: MA2 gate failed: {means}")
    return means


def phase_main_path(device):
    from elfi_tpu_torch.models import ma2, ma2_kernel
    from elfi_tpu_torch.ops.kernels.ma2 import ma2_distance
    from elfi_tpu_torch.ops.kernels.topn import topn_cull
    out = {}
    # warm-up: allocator and generators, two batches each
    for mod, bs in ((ma2, PLAIN_BATCH), (ma2_kernel, KERNEL_BATCH)):
        import elfi_tpu_torch as et
        m = mod.get_model(seed_obs=SEED_OBS)
        et.Rejection(m["d"], batch_size=bs, seed=0, device=device).sample(
            N_SAMPLES, n_sim=2 * bs, bar=False)
    torch.cuda.synchronize()

    for name, mod, bs, expect in (
            ("plain graph", ma2, PLAIN_BATCH, 0),
            ("kernel graph", ma2_kernel, KERNEL_BATCH,
             math.ceil(N_SIM / KERNEL_BATCH))):
        reset_counts(ma2_distance, topn_cull)
        res, dt = timed_sample(mod.get_model(seed_obs=SEED_OBS)["d"], bs,
                               N_SAMPLES, N_SIM, device)
        launches = ran(ma2_distance)
        cull = ran(topn_cull)
        means = check_sample(res, bs, name)
        sims_s = res.n_sim / dt
        log(f"{name}: batch {bs}, {res.n_batches} batches, {res.n_sim} sims "
            f"in {dt!r} s = {sims_s!r} sims/s; ma2_distance launches "
            f"{launches} (expected {expect}); topn_cull launches {cull}")
        check(launches == expect, f"{name}: ma2_distance launched "
              f"{launches} times, expected {expect}")
        check(cull > 0, f"{name}: the merge never went through topn_cull")
        out[name] = dict(seconds=dt, sims_per_s=sims_s, launches=launches,
                         merge_launches=cull, means=means.tolist(),
                         n_batches=res.n_batches)
    return out


MERGE_BATCHES = (PLAIN_BATCH, KERNEL_BATCH)
MERGE_STEADY = 14        # uniform batches of the steady state, per size
MERGE_LIMIT_S = 30.0
MERGE_PROFILED = 20          # merges in the cull's profile
MERGE_PROFILED_BATCHES = 32  # batches in the kernel graph's profile


def _bits(x):
    """The bytes of ``x``: bitwise equality, NaN included."""
    return x.contiguous().view(torch.uint8)


def merge_cases(device, batch, n, width, seed):
    """The merges phase_merge holds the cull kernel to, in order: yields
    (case, buffers, batch, threshold, candidates expected or None), each
    input buffer the flat merge's after the cases before.  Three streams,
    41 merges: (1) a 1-D distance carrying t1 (a strided column), t2 (B, 2)
    and an int64 ``__pos``: a fresh buffer, a candidate count just above
    and well above ``width``, counts at the edges of the kernel's counting
    sort, its copies of every tile and its one-pass capacity (each minus
    one, equal, plus one), exact ties at the N-th key and at other buffer
    keys, steady batches (every fourth with NaN and +inf
    distances), a threshold that rejects everything, a one-element
    threshold tensor; (2) a threshold that keeps the buffer partly +inf;
    (3) a 2-D distance under a vector threshold."""
    from elfi_tpu_torch.ops import topk
    from elfi_tpu_torch.ops.kernels.topn import (CAPACITY, COUNT_SORT,
                                                 LOCAL_TILES)
    g = torch.Generator(device=device).manual_seed(seed)
    pos = [0]

    def rand(*shape):
        return torch.rand(shape, generator=g, device=device)

    def columns(d):
        b = d.shape[0]
        pair = torch.randn((b, 2), generator=g, device=device)
        out = {"d": d, "t1": pair[:, 0],
               "t2": torch.randn((b, 2), generator=g, device=device),
               "__pos": torch.arange(pos[0], pos[0] + b, device=device)}
        pos[0] += b
        return out

    def below(kth, count):
        """Uniform distances in [kth, 1) with ``count`` rows below kth."""
        d = kth + (1 - kth) * rand(batch)
        rows = torch.randperm(batch, generator=g, device=device)[:count]
        d[rows] = kth * 0.999 * rand(count)
        return d

    def merged(bufs, b, thr):
        return topk.merge_core(bufs, b, thr, "d")[0]

    b = columns(rand(batch))
    bufs = topk.init_buffers(n, b, "d")
    yield "fresh buffer", bufs, b, math.inf, batch
    bufs = merged(bufs, b, math.inf)
    edges = [(f"count {what} {c + e}", c + e)
             for what, c in (("at the counting sort's edge", 8 * COUNT_SORT),
                             ("at the tiles' copies", LOCAL_TILES),
                             ("at capacity", CAPACITY))
             for e in (-1, 0, 1)]
    for case, count in (("count just above the width", width + width // 4),
                        ("count well above the width", 4 * width + 123),
                        *edges):
        kth = float(bufs["__key"][n - 1])
        b = columns(below(kth, count))
        yield case, bufs, b, math.inf, count
        bufs = merged(bufs, b, math.inf)
    kth = float(bufs["__key"][n - 1])
    d = below(kth, width // 2)
    d[torch.randperm(batch, generator=g, device=device)[:batch // 4]] = kth
    rows = torch.randperm(batch, generator=g, device=device)[:37]
    d[rows] = bufs["__key"][torch.randint(0, n - 1, (37,), generator=g,
                                          device=device)]
    b = columns(d)
    yield "ties at the N-th key and at buffer keys", bufs, b, math.inf, None
    bufs = merged(bufs, b, math.inf)
    for s in range(MERGE_STEADY):
        d = rand(batch)
        if s % 4 == 3:
            d[torch.randperm(batch, generator=g, device=device)[
                :batch // 8]] = math.nan
            d[torch.randperm(batch, generator=g, device=device)[
                :batch // 16]] = math.inf
        b = columns(d)
        yield f"steady {s}", bufs, b, math.inf, None
        bufs = merged(bufs, b, math.inf)
    b = columns(rand(batch))
    yield "threshold rejecting everything", bufs, b, -1.0, 0
    thr = torch.tensor([0.5], device=device)
    b = columns(rand(batch))
    yield "one-element threshold tensor", bufs, b, thr, None

    thr = float(np.float32(n / 8 / batch))
    b = columns(rand(batch))
    bufs = topk.init_buffers(n, b, "d")
    for s in range(6):
        yield f"partly +inf buffer {s}", bufs, b, thr, None
        bufs = merged(bufs, b, thr)
        b = columns(rand(batch))

    thr = torch.tensor([0.9, 0.6], device=device)
    b = columns(rand(batch, 2))
    bufs = topk.init_buffers(n, b, "d")
    for s in range(6):
        yield f"2-D distance, vector threshold {s}", bufs, b, thr, None
        bufs = merged(bufs, b, thr)
        b = columns(rand(batch, 2))


def candidates(bufs, b, thr):
    """The rows of ``b`` whose effective key beats the buffer's N-th."""
    from elfi_tpu_torch.ops import topk
    d = b["d"]
    keys = torch.where(topk.accept_mask(d, thr),
                       topk.sort_key(d).to(torch.float32), math.inf)
    return int((keys < bufs["__key"][-1]).sum())


def cull_input(device, batch, count, seed):
    """A full buffer and a main-path batch (d, t1, t2) with ``count`` rows
    beating its N-th key."""
    from elfi_tpu_torch.ops import topk
    g = torch.Generator(device=device).manual_seed(seed)
    b = {k: torch.rand(batch, generator=g, device=device)
         for k in ("d", "t1", "t2")}
    bufs, _ = topk.merge_core(topk.init_buffers(N_SAMPLES, b, "d"), b,
                              math.inf, "d")
    kth = float(bufs["__key"][-1])
    d = kth + (1 - kth) * torch.rand(batch, generator=g, device=device)
    rows = torch.randperm(batch, generator=g, device=device)[:count]
    d[rows] = kth * 0.999 * torch.rand(count, generator=g, device=device)
    return bufs, dict(b, d=d)


def host_us(fn, reps=200):
    """Host microseconds to queue ``fn()``, over ``reps`` calls queued
    back to back after a synchronise."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e6


def cull_bound_ms(batch, n, columns):
    """The least time of a merge on this card: the batch's distances read
    once, the buffer's keys and the chosen rows of each column read once,
    the keys, the index map and each column's rows written once, over
    HBM's rate."""
    nbytes = batch * 4 + n * 4 + n * (4 + 8) + 2 * n * sum(columns)
    return nbytes / HBM_BYTES_S * 1e3


def phase_merge(device):
    """The culled merge on the card: (a) the cull kernel against its plain
    version on the sequence of :func:`merge_cases` at both main-path batch
    sizes, bit for bit (keys, index map, every column, the acceptance
    count), both against the flat merge; (b) the fused MA2 rejection on
    both graphs at the main path's point under the chosen settings against
    the flat merge with no unroll, bit for bit, gated, the quantile-mode
    loop under ``torch.cuda.set_sync_debug_mode("error")``; (c) times:
    the kernel at four candidate counts, by kernel from one profile, its
    device operations a merge (at most two, no memset), the host's time to
    queue one, and the MA2 kernel graph's busy share."""
    import elfi_tpu_torch as et
    from elfi_tpu_torch.methods import samplers
    from elfi_tpu_torch.models import ma2, ma2_kernel
    from elfi_tpu_torch.ops import topk
    from elfi_tpu_torch.ops.kernels.topn import (CAPACITY, topn_cull,
                                                 topn_cull_reference)
    t_phase = time.perf_counter()
    widths = topk.CULL_SMALL_K
    width = max(widths) if isinstance(widths, tuple) else widths
    out = {"width": width, "cull_small_k": widths,
           "cull_min_batch": topk.CULL_MIN_BATCH,
           "merge_variant": topk.MERGE_VARIANT}

    # (a) bit for bit on every case
    counts = {}
    for batch in MERGE_BATCHES:
        cases = 0
        for case, bufs, b, thr, expect in merge_cases(
                device, batch, N_SAMPLES, width, seed=batch):
            count = candidates(bufs, b, thr)
            if expect is not None:
                check(count == expect, f"merge case {case} at {batch}: "
                      f"{count} candidates, expected {expect}")
            got, idx, acc = topn_cull(bufs, b, thr, "d", widths)
            want, widx, wacc = topn_cull_reference(bufs, b, thr, "d",
                                                   widths)
            flat, facc = topk.merge_core(bufs, b, thr, "d")
            what = f"topn_cull, case {case!r} at B={batch}"
            check(torch.equal(idx, widx), f"{what}: index map differs")
            check(int(acc) == int(wacc) == int(facc),
                  f"{what}: acceptance {int(acc)}, plain {int(wacc)}, "
                  f"flat {int(facc)}")
            check(set(got) == set(want) == set(flat), f"{what}: columns")
            for k in want:
                check(got[k].dtype == want[k].dtype
                      and got[k].shape == want[k].shape
                      and torch.equal(_bits(got[k]), _bits(want[k]))
                      and torch.equal(_bits(got[k]), _bits(flat[k])),
                      f"{what}: {k} differs")
            counts[f"{batch}: {case}"] = count
            cases += 1
        check(cases >= 41, f"only {cases} merge cases")
    torch.cuda.synchronize()
    log(f"merge (a): topn_cull == its plain version == the flat merge, bit "
        f"for bit (keys, index map, every column, acceptance), on "
        f"{cases} merges at each of {MERGE_BATCHES} (width {width}); "
        f"candidates per case {counts}")
    out["cases_per_batch"] = cases
    out["max_abs_err"] = 0.0

    # (b) the main path, chosen settings against flat with no unroll
    for name, mod, bs in (("plain graph", ma2, PLAIN_BATCH),
                          ("kernel graph", ma2_kernel, KERNEL_BATCH)):
        node = mod.get_model(seed_obs=SEED_OBS)["d"]
        saved = topk.MERGE_VARIANT, samplers.FUSED_UNROLL
        try:
            topk.MERGE_VARIANT, samplers.FUSED_UNROLL = "flat", 1
            reset_counts(topn_cull)
            base, wall_flat = timed_sample(node, bs, N_SAMPLES, N_SIM,
                                           device, seed=2)
            check(ran(topn_cull) == 0, "the flat merge launched the cull")
        finally:
            topk.MERGE_VARIANT, samplers.FUSED_UNROLL = saved
        rej = et.Rejection(node, batch_size=bs, seed=2, device=device)
        rej._run_fused = sync_guarded(rej._run_fused)
        reset_counts(topn_cull)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = rej.sample(N_SAMPLES, n_sim=N_SIM, bar=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ran(topn_cull)
        check_equal_samples(res, base, f"merge (b) {name}: chosen settings "
                            "against flat with no unroll")
        check_sample(res, bs, f"merge (b) {name}")
        unroll = samplers._fused_unroll(bs, {k: torch.empty(
            (1,), dtype=torch.float32) for k in ("d", "t1", "t2")})
        log(f"merge (b) {name}: equal to the flat merge with no unroll; "
            f"unroll {unroll}, topn_cull launches {launches}; the quantile "
            f"loop under the sync guard; wall {wall!r} s against flat "
            f"{wall_flat!r} s ({N_SIM / wall!r} against {N_SIM / wall_flat!r}"
            " sims/s)")
        out[name] = dict(wall_s=wall, flat_wall_s=wall_flat, unroll=unroll,
                         launches=launches)

    # (c) times at the kernel graph's batch: the cull at four candidate
    # counts with its launches queued ahead and with the host's queueing,
    # its plain version (which reads the count on the host), the flat
    # merge and torch.topk; the kernels' device time from one profile, the
    # host's time to queue a merge, and the kernel graph's busy share
    times, event = {}, {}
    for label, count in (("n/16", N_SAMPLES // 16), ("4096", 4096),
                         ("16384", 16384), ("capacity", CAPACITY)):
        bufs, b = cull_input(device, KERNEL_BATCH, count, seed=count)
        check(candidates(bufs, b, math.inf) == count,
              f"cull input {label}: not {count} candidates")
        times[label] = queued_ms(lambda: topn_cull(bufs, b, math.inf, "d",
                                                   widths))
        event[label] = time_ms(lambda: topn_cull(bufs, b, math.inf, "d",
                                                 widths))
        if label != "n/16":
            continue
        out["plain_ms"] = time_ms(lambda: topn_cull_reference(
            bufs, b, math.inf, "d", widths))
        out["flat_ms"] = queued_ms(lambda: topk.merge_core(
            bufs, b, math.inf, "d"))
        cat = torch.cat([bufs["__key"], b["d"]])
        out["library_ms"] = queued_ms(lambda: torch.topk(
            cat, N_SAMPLES, largest=False, sorted=True))
        out["host_us"] = {
            "topn_cull": host_us(lambda: topn_cull(bufs, b, math.inf, "d",
                                                   widths)),
            "merge_core": host_us(lambda: topk.merge_core(
                bufs, b, math.inf, "d"))}
        _, prof = profiled(lambda: [topn_cull(bufs, b, math.inf, "d", widths)
                                    for _ in range(MERGE_PROFILED)])
        events, device_us = device_table(prof)
        ops = card_events(events)
        out["by_kernel_ms"] = {e.key: e.self_device_time_total / 1e3
                               / MERGE_PROFILED for e in ops}
        out["device_ops_per_merge"] = sum(e.count for e in ops) \
            / MERGE_PROFILED
        check(out["device_ops_per_merge"] <= 2
              and not any("emset" in e.key for e in ops),
              f"a merge took {out['device_ops_per_merge']} device "
              f"operations: {out['by_kernel_ms']}")
    out["ms_by_count"] = times
    out["event_ms_by_count"] = event
    out["ms"] = times["n/16"]
    out["event_ms"] = event["n/16"]
    out["bound_ms"] = cull_bound_ms(KERNEL_BATCH, N_SAMPLES, (4, 4, 4))

    node = ma2_kernel.get_model(seed_obs=SEED_OBS)["d"]
    rej = et.Rejection(node, batch_size=KERNEL_BATCH, seed=2, device=device)
    rej.sample(N_SAMPLES, n_sim=2 * KERNEL_BATCH, bar=False)
    _, prof = profiled(lambda: rej.sample(
        N_SAMPLES, n_sim=MERGE_PROFILED_BATCHES * KERNEL_BATCH, bar=False))
    events, device_us = device_table(prof)
    graph = out["kernel graph"]
    graph["device_ms_per_batch"] = device_us / 1e3 / MERGE_PROFILED_BATCHES
    graph["wall_ms_per_batch"] = graph["wall_s"] * 1e3 / (
        N_SIM // KERNEL_BATCH)
    graph["busy_share"] = (graph["device_ms_per_batch"]
                           / graph["wall_ms_per_batch"])
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "profile_merge_kernel_graph.txt").write_text(events.table(
        sort_by="self_device_time_total", row_limit=30))
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"merge (c) B={KERNEL_BATCH}, n={N_SAMPLES}: topn_cull "
        f"{times!r} ms by candidate count (launches queued ahead), "
        f"{event!r} ms a call with the host's queueing; by kernel "
        f"{out['by_kernel_ms']!r} ms, {out['device_ops_per_merge']!r} "
        f"device operations a merge (profiled); plain "
        f"{out['plain_ms']!r}, flat merge {out['flat_ms']!r}, torch.topk "
        f"{out['library_ms']!r}, bound {out['bound_ms']!r} ms (median of "
        f"25, CUDA events); host us to queue a merge {out['host_us']!r}; "
        f"MA2 kernel graph {graph['device_ms_per_batch']!r} device ms a "
        f"batch ({MERGE_PROFILED_BATCHES} profiled) against "
        f"{graph['wall_ms_per_batch']!r} wall ms (b), busy "
        f"{graph['busy_share']!r}; phase {out['wall_s']!r} s (limit "
        f"{MERGE_LIMIT_S}) on {card_line()}")
    log_top(events, device_us, MERGE_PROFILED_BATCHES)
    check(out["wall_s"] < MERGE_LIMIT_S, f"the merge phase took "
          f"{out['wall_s']} s")
    return out


def gnk_observed_sorted(n_obs, device):
    """The sorted observed g-and-k sample at n_obs 50 (seed_obs 1),
    generated on ``device``; for the other widths of the kernel checks, a
    sorted sample of N(3, 1)."""
    from elfi_tpu_torch.models import gnk
    if n_obs == GNK_N_OBS:
        y = gnk.observed_data(n_obs=n_obs, seed_obs=GNK_SEED_OBS,
                              device=device)
    else:
        y = np.random.default_rng(n_obs).normal(3.0, 1.0, n_obs)
    return torch.tensor(np.sort(np.ravel(y)), dtype=torch.float32,
                        device=device)


def gnk_prior_params(batch, device, seed):
    """(A, B, g, k) drawn from the g-and-k priors, uniform(0, 10)."""
    g = torch.Generator(device=device).manual_seed(seed)
    return [10.0 * torch.rand(batch, generator=g, device=device)
            for _ in range(4)]


def phase_gnk_kernel_checks(device):
    """K2 against its plain version on the card, and the times per call."""
    from elfi_tpu_torch.ops import topk
    from elfi_tpu_torch.ops.kernels.gnk import (MAX_N_OBS, NETWORK_ROWS,
                                                gnk_distance,
                                                gnk_distance_noise,
                                                gnk_distance_reference,
                                                gnk_sort_rows)

    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)

    result = {"max_abs_err": 0.0, "max_rel_err": 0.0}
    # the same normals in both: the kernel's arithmetic, exactly
    for batch in (2**16, GNK_BATCH):
        P = gnk_prior_params(batch, device, seed=batch)
        for n_obs in (17, GNK_N_OBS, MAX_N_OBS):
            obs = gnk_observed_sorted(n_obs, device)
            z = torch.randn((batch, n_obs), generator=gen(11), device=device)
            d_k = gnk_distance_noise(*P, obs, z)
            d_p = gnk_distance_reference(*P, obs, n_obs, batch_size=batch,
                                         z=z)
            torch.cuda.synchronize()
            err = (d_k - d_p).abs()
            max_abs = float(err.max())
            max_rel = float((err / d_p.abs()).max())
            log(f"K2 noise-injected B={batch} n_obs={n_obs}: max_abs_err="
                f"{max_abs!r} max_rel_err={max_rel!r} (tolerance rel 1e-5)")
            check(bool(torch.isfinite(d_k).all()), "K2 output not finite")
            check(max_rel <= 1e-5, f"K2 disagrees with its plain version: "
                  f"max relative error {max_rel} > 1e-5")
            result["max_abs_err"] = max(result["max_abs_err"], max_abs)
            result["max_rel_err"] = max(result["max_rel_err"], max_rel)
            del z

    # each instance's sorting network alone against torch.sort, +inf pads
    # and ties
    for rows in NETWORK_ROWS:
        y = torch.randn((2**20, rows), generator=gen(12), device=device)
        y[::2, 17:] = math.inf
        y[1::4, 40:] = y[1::4, :1]
        check(torch.equal(gnk_sort_rows(y), torch.sort(y, dim=1).values),
              f"K2's {rows}-row sorting network differs from torch.sort")
        log(f"K2 sort network == torch.sort on {y.shape[0]} rows of "
            f"{rows}, +inf pads and ties included")
        del y

    # the kernel's own Philox stream against torch.randn: statistics
    batch = 2**20
    P = [torch.full((batch,), v, device=device) for v in (3.0, 1.0, 2.0, .5)]
    obs = gnk_observed_sorted(GNK_N_OBS, device)
    d_k = gnk_distance(*P, obs, GNK_N_OBS, batch_size=batch,
                       generator=gen(0))
    d_p = gnk_distance_reference(*P, obs, GNK_N_OBS, batch_size=batch,
                                 generator=gen(1))
    stats = [float(x) for x in (d_k.mean(), d_p.mean(), d_k.median(),
                                d_p.median())]
    log(f"K2 RNG path B={batch}: mean kernel={stats[0]!r} plain="
        f"{stats[1]!r} median kernel={stats[2]!r} plain={stats[3]!r} "
        f"(tolerance 15 %)")
    check(bool(torch.isfinite(d_k).all()), "K2 output not finite")
    check(abs(stats[0] - stats[1]) < 0.15 * stats[1],
          "K2 distance means disagree")
    check(abs(stats[2] - stats[3]) < 0.15 * stats[3],
          "K2 distance medians disagree")
    a = gnk_distance(*P, obs, GNK_N_OBS, batch_size=batch,
                     generator=gen(3))
    b = gnk_distance(*P, obs, GNK_N_OBS, batch_size=batch,
                     generator=gen(3))
    c = gnk_distance(*P, obs, GNK_N_OBS, batch_size=batch,
                     generator=gen(4))
    check(torch.equal(a, b), "K2 is not deterministic for one seed")
    check(not torch.equal(a, c), "K2 gives the same output for two seeds")
    log("K2 determinism: same seed equal, different seed differs")

    # times per call at the g-and-k graphs' batch
    P = gnk_prior_params(GNK_BATCH, device, seed=5)
    g_k, g_p = gen(21), gen(22)
    result["ms"] = time_ms(lambda: gnk_distance(
        *P, obs, GNK_N_OBS, batch_size=GNK_BATCH, generator=g_k))
    result["plain_ms"] = time_ms(lambda: gnk_distance_reference(
        *P, obs, GNK_N_OBS, batch_size=GNK_BATCH, generator=g_p))
    log(f"K2 B={GNK_BATCH}: kernel {result['ms']!r} ms/call, plain "
        f"{result['plain_ms']!r} ms/call (median of 25, CUDA events)")
    out = dict(zip(GNK_NAMES, P))
    out["d"] = gnk_distance(*P, obs, GNK_N_OBS, batch_size=GNK_BATCH,
                            generator=gen(8))
    bufs = topk.init_buffers(N_SAMPLES, out, "d")
    bufs, _ = topk.merge_core(bufs, out, math.inf, "d")
    result["merge_ms"] = time_ms(
        lambda: topk.merge_core(bufs, out, math.inf, "d"))
    log(f"top-N merge n={N_SAMPLES} B={GNK_BATCH} (g-and-k outputs): "
        f"{result['merge_ms']!r} ms/call")
    return result


def phase_gnk_main_path(device):
    """Both g-and-k graphs at scripts/gnk_ab.py's operating point."""
    from elfi_tpu_torch.models import gnk, gnk_kernel
    from elfi_tpu_torch.ops.kernels.gnk import gnk_distance
    from elfi_tpu_torch.ops.kernels.topn import topn_cull
    graphs = (("gnk plain graph", gnk, 0),
              ("gnk kernel graph", gnk_kernel,
               math.ceil(GNK_N_SIM / GNK_BATCH)))
    for _, mod, _ in graphs:       # warm-up: allocator and generators
        timed_sample(mod.get_model(n_obs=GNK_N_OBS,
                                   seed_obs=GNK_SEED_OBS)["d"],
                     GNK_BATCH, N_SAMPLES, 2 * GNK_BATCH, device, seed=0)
    out = {}
    for name, mod, expect in graphs:
        reset_counts(gnk_distance, topn_cull)
        torch.cuda.reset_peak_memory_stats(device)
        m = mod.get_model(n_obs=GNK_N_OBS, seed_obs=GNK_SEED_OBS)
        res, dt = timed_sample(m["d"], GNK_BATCH, N_SAMPLES, GNK_N_SIM,
                               device)
        launches = ran(gnk_distance)
        cull = ran(topn_cull)
        peak = torch.cuda.max_memory_allocated(device)
        d = res.outputs["d"]
        check(d.shape == (N_SAMPLES,), f"{name}: d has shape {d.shape}")
        check(bool(np.all(np.isfinite(d))), f"{name}: non-finite distances")
        check(bool(np.all(np.diff(d) >= 0)), f"{name}: distances not sorted")
        check(res.n_sim == GNK_N_SIM, f"{name}: n_sim {res.n_sim}")
        check(bool(np.all(np.isfinite(res.samples_array))),
              f"{name}: non-finite parameters")
        means = np.array([np.mean(res.samples[k]) for k in GNK_NAMES])
        err = np.abs(means - GNK_JAX_MEANS)
        sims_s = res.n_sim / dt
        log(f"{name}: posterior means {means.tolist()!r} |err| from JAX "
            f"{err.tolist()!r} (gate < {GNK_GATE.tolist()}) threshold "
            f"{float(d[-1])!r}")
        log(f"{name}: batch {GNK_BATCH}, {res.n_batches} batches, "
            f"{res.n_sim} sims in {dt!r} s = {sims_s!r} sims/s; "
            f"gnk_distance launches {launches} (expected {expect}); "
            f"topn_cull launches {cull}; peak device memory {peak} bytes")
        check(bool(np.all(err < GNK_GATE)),
              f"{name}: g-and-k gate failed: {means}")
        check(launches == expect, f"{name}: gnk_distance launched "
              f"{launches} times, expected {expect}")
        check(cull > 0, f"{name}: the merge never went through topn_cull")
        out[name] = dict(seconds=dt, sims_per_s=sims_s, launches=launches,
                         merge_launches=cull, means=means.tolist(),
                         n_batches=res.n_batches, peak_bytes=peak)
    return out


# The observed phase: the zoo's observed data generated on the card from
# the Threefry streams, and the main path's kernels on data no file holds.
OBS_MA2_SEED = 1             # the lowest MA2 seed_obs not in ma2_observed.npz
OBS_GNK_SEED = 4             # the lowest g-and-k seed_obs not in gnk_observed
# 0.01: about 4 (t1) and 3 (t2) combined Monte-Carlo SEs of the two runs'
# top-5000 means (the JAX run's posterior sds 0.126 and 0.175)
OBS_MA2_GATE = 0.01
# Posterior means (t1, t2) of the JAX package for the same setting, n_sim
# and n_samples on the plain graph, on the CPU:
#   python -c 'import jax; jax.config.update("jax_platforms", "cpu");
#   import elfi_tpu as elfi; from elfi_tpu.models import ma2;
#   m = ma2.get_model(seed_obs=1);
#   r = elfi.Rejection(m["d"], batch_size=2**17, seed=1).sample(
#       5000, n_sim=2048 * 2**17, bar=False);
#   print([float(r.samples[k].mean()) for k in ("t1", "t2")])'
OBS_MA2_JAX_MEANS = np.array([0.7293426394462585, 0.7249208092689514])
# ... and (A, B, g, k) for the g-and-k call of phase 7 at seed_obs 4:
#   python -c 'import jax; jax.config.update("jax_platforms", "cpu");
#   import elfi_tpu as elfi; from elfi_tpu.models import gnk;
#   m = gnk.get_model(n_obs=50, seed_obs=4);
#   r = elfi.Rejection(m["d"], batch_size=2**21, seed=1).sample(
#       5000, n_sim=2**26, bar=False);
#   print([float(r.samples[k].mean()) for k in "ABgk"])'
OBS_GNK_JAX_MEANS = np.array([3.0233232975006104, 1.3733577728271484,
                              5.362576007843018, 0.2818874716758728])
OBS_LIMIT_S = 60.0
#: tolerances of the generated data (tests/unit/test_torch_zoo_observed.py):
#: 0 is equality, a float is an rtol of the array's largest magnitude, and
#: ("atol", x) an absolute tolerance
OBS_TOL = {"ma2": 1e-6, "gnk": 1e-6, "bignk": 1e-6, "gauss": 1e-6,
           "ar1": 1e-6, "arch": 1e-5, "mg1": 1e-5,
           "stochastic_volatility": 1e-5, "toad": 1e-5, "ricker": 0,
           "lotka_volterra": 0, "daycare": 0, "lorenz": ("atol", 1e-2)}
OBS_NODE = {"ma2": "MA2", "gnk": "GNK", "bignk": "BiGNK", "gauss": "gauss",
            "ar1": "AR1", "arch": "Y", "mg1": "MG1",
            "stochastic_volatility": "a_svm", "toad": "toad",
            "ricker": "Ricker", "lotka_volterra": "LV", "daycare": "DCC",
            "lorenz": "Lorenz"}
#: one setting of each model that no file holds: the card against the CPU
OBS_UNSTORED = [
    ("ma2", dict(seed_obs=OBS_MA2_SEED)),
    ("gnk", dict(seed_obs=OBS_GNK_SEED)),
    ("bignk", dict(seed_obs=5, n_obs=70)),
    ("gauss", dict(nd_mean=True, cov_matrix=2 * np.eye(2))),
    ("ar1", dict(n_obs=500, seed_obs=2, true_params=[.5])),
    ("arch", dict(seed_obs=6, n_obs=70, true_params=[.1, .4])),
    ("mg1", dict(seed_obs=6, n_obs=70, true_params=[.5, 3., .3])),
    ("stochastic_volatility", dict(seed_obs=8, n_obs=80,
                                   true_params=[1.5, -.3])),
    ("toad", dict(seed_obs=9, true_params=[1.3, 20., .4])),
    ("ricker", dict(seed_obs=11, n_obs=80, true_params=[4.2, .2, 20.])),
    ("lorenz", dict(seed_obs=5, initial_state=np.linspace(-1, 5, 40))),
    ("lotka_volterra", dict(seed_obs=6, n_obs=20, time_end=10.,
                            observation_noise=True)),
    ("daycare", dict(seed_obs=8, n_dcc=3, n_ind=12, n_strains=6, n_obs=8,
                     time_end=1.))]


def committed_settings():
    """(model, get_model arguments, the JAX package's array) for every
    array in ``elfi_tpu_torch/models/data/*_observed.npz``."""
    import ast
    from elfi_tpu_torch import models
    by_key = {"ma2": {}, "gnk": {}, "bignk": {},
              "gauss": {"nd_seed_0": GAUSS_KW},
              "ricker": {"deterministic_seed_0": dict(stochastic=False),
                         "bench_seed_4": dict(seed_obs=4)}}
    out = []
    for path in sorted((Path(models.__file__).parent / "data").glob(
            "*_observed.npz")):
        name = path.name[:-len("_observed.npz")]
        with np.load(path) as data:
            for key in data.files:
                if "=" in key:
                    kw = {k: ast.literal_eval(v) for k, v in
                          (part.split("=", 1) for part in key.split(";"))}
                else:
                    kw = by_key[name].get(
                        key, dict(seed_obs=int(key.rsplit("_", 1)[1])))
                out.append((name, kw, data[key]))
    return out


def observed_gap(name, got, want):
    """The largest gap of ``got`` from ``want`` in the unit its tolerance
    is stated in, and whether it is within that tolerance."""
    tol = OBS_TOL[name]
    if got.shape != want.shape:
        return math.inf, False
    if isinstance(tol, tuple):
        gap = float(np.max(np.abs(got - want)))
        return gap, gap <= tol[1]
    scale = float(np.max(np.abs(want))) or 1.0
    gap = float(np.max(np.abs(got - want))) / scale
    return gap, gap <= tol


def too_long(name, kw):
    """The committed settings left out of the card's generation: the
    Lotka-Volterra event loop at 50 observations over 30 time units takes
    about 10,000 steps of some 40 launches each at batch 1, 8.5-10.4 s on
    the card (probe, PR 15); its small setting (8 observations over 5)
    stands in, and the CPU tests hold the generator to the JAX package."""
    return name == "lotka_volterra" and kw.get("n_obs", 50) == 50 \
        and kw.get("time_end", 30.) == 30.


def observed_data_checks():
    """The zoo's observed data generated through ``get_model``'s default
    device (the card), against the port's CPU result and the JAX package's
    committed arrays; returns the walls and the largest gaps."""
    import importlib
    import elfi_tpu_torch as et
    check(et.get_client().device.type == "cuda",
          "the global backend's device is not the card")
    t_phase = time.perf_counter()
    gaps, walls, failed = {}, {}, []
    cases = [(name, kw, want, True) for name, kw, want in
             committed_settings()]
    cases += [(name, kw, None, False) for name, kw in OBS_UNSTORED]
    for name, kw, want, stored in cases:
        label = ";".join(f"{k}={v}" for k, v in kw.items()
                         if k != "initial_state")
        if too_long(name, kw):
            log(f"observed: {name} {label}: not generated on the card (an "
                "event loop of about 10,000 steps at batch 1; the small "
                "setting stands in)")
            continue
        mod = importlib.import_module(f"elfi_tpu_torch.models.{name}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card = mod.get_model(**kw).observed[OBS_NODE[name]]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = mod.observed_data(**kw, device="cpu")
        cpu_s = time.perf_counter() - t0
        walls[f"{name} {label}"] = wall
        gap, ok = observed_gap(name, card, cpu)
        gaps.setdefault(name, {"card_cpu": 0.0, "card_jax": 0.0})
        gaps[name]["card_cpu"] = max(gaps[name]["card_cpu"], gap)
        if not ok:
            failed.append(f"{name} {label}: card vs CPU {gap}")
        if stored:
            gap, ok = observed_gap(name, card, want)
            gaps[name]["card_jax"] = max(gaps[name]["card_jax"], gap)
            if not ok:
                failed.append(f"{name} {label}: card vs JAX {gap}")
        log(f"observed: {name} {label}: {wall!r} s on the card, {cpu_s!r} s"
            " on the CPU")
    for name, g in gaps.items():
        log(f"observed: {name}: largest gap card vs CPU {g['card_cpu']!r}, "
            f"card vs the JAX arrays {g['card_jax']!r} (tolerance "
            f"{OBS_TOL[name]!r})")
    check(not failed, "observed data out of tolerance: " + "; ".join(failed))
    return {"generation_s": time.perf_counter() - t_phase, "walls_s": walls,
            "gaps": gaps}


def phase_observed(device):
    """The observed data of every zoo model generated on the card
    (:func:`observed_data_checks`); then MA2 rejection on the K1 graph at
    seed_obs 1 and g-and-k on the K2 graph at seed_obs 4, data no file
    holds, against the JAX package's posterior means for the same calls."""
    from elfi_tpu_torch.models import gnk_kernel, ma2_kernel
    from elfi_tpu_torch.ops.kernels.gnk import gnk_distance
    from elfi_tpu_torch.ops.kernels.ma2 import ma2_distance
    from elfi_tpu_torch.ops.kernels.topn import topn_cull
    t_phase = time.perf_counter()
    out = observed_data_checks()
    generation_s = out["generation_s"]

    for label, mod, kw, bs, n_sim, kernel, want, gate, names in (
            ("ma2 kernel graph, seed_obs 1", ma2_kernel,
             dict(seed_obs=OBS_MA2_SEED), KERNEL_BATCH, N_SIM, ma2_distance,
             OBS_MA2_JAX_MEANS, np.full(2, OBS_MA2_GATE), ("t1", "t2")),
            ("gnk kernel graph, seed_obs 4", gnk_kernel,
             dict(n_obs=GNK_N_OBS, seed_obs=OBS_GNK_SEED), GNK_BATCH,
             GNK_N_SIM, gnk_distance, OBS_GNK_JAX_MEANS, GNK_GATE,
             GNK_NAMES)):
        m = mod.get_model(**kw)
        timed_sample(m["d"], bs, N_SAMPLES, 2 * bs, device, seed=0)
        reset_counts(kernel, topn_cull)
        res, dt = timed_sample(m["d"], bs, N_SAMPLES, n_sim, device)
        launches, cull = ran(kernel), ran(topn_cull)
        expect = math.ceil(n_sim / bs)
        d = res.outputs["d"]
        check(d.shape == (N_SAMPLES,) and bool(np.all(np.isfinite(d))),
              f"{label}: distances {d.shape}")
        check(res.n_sim == n_sim, f"{label}: n_sim {res.n_sim}")
        x = np.stack([res.samples[k] for k in names], axis=1)
        check(bool(np.all(np.isfinite(x))), f"{label}: non-finite samples")
        means = x.mean(axis=0)
        se = x.std(axis=0, ddof=1) / math.sqrt(len(x))
        err = np.abs(means - want)
        log(f"observed: {label}: posterior means {means.tolist()!r} |err| "
            f"from JAX {err.tolist()!r} (gate < {gate.tolist()}), "
            f"Monte-Carlo SEs {se.tolist()!r}; {res.n_sim} sims in {dt!r} s;"
            f" {kernel.__name__} launches {launches} (expected {expect}); "
            f"topn_cull launches {cull}")
        check(bool(np.all(err < gate)), f"{label}: gate failed: {means}")
        check(launches == expect, f"{label}: {kernel.__name__} launched "
              f"{launches} times, expected {expect}")
        check(cull > 0, f"{label}: the merge never went through topn_cull")
        out[label] = dict(seconds=dt, sims_per_s=res.n_sim / dt,
                          launches=launches, merge_launches=cull,
                          means=means.tolist(), se=se.tolist())
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"observed phase: {out['wall_s']!r} s (generation "
        f"{generation_s!r} s, limit {OBS_LIMIT_S})")
    check(out["wall_s"] < OBS_LIMIT_S,
          f"the observed phase took {out['wall_s']} s")
    return out


def phase_adaptive(device):
    """Rejection with an adaptive distance over the g-and-k octiles."""
    import elfi_tpu_torch as et
    from elfi_tpu_torch.models import gnk

    def run():
        m = gnk.get_model(n_obs=GNK_N_OBS, seed_obs=GNK_SEED_OBS)
        et.Summary(gnk.ss_octile, m["GNK"], model=m, name="octiles")
        et.AdaptiveDistance(m["octiles"], model=m, name="ad")
        res, dt = timed_sample(m["ad"], 2**16, 1000, 2**20, device, seed=4)
        return res, m["ad"].adaptive_state["w"], dt

    (r1, w1, dt), (r2, w2, _) = run(), run()
    check(len(w1) == 2 and w1[0] is None, f"adaptive: weights {w1}")
    check(w1[1].shape == (7,) and bool(np.all(np.isfinite(w1[1])))
          and bool(np.all(w1[1] > 0)), f"adaptive: bad weights {w1[1]}")
    d = r1.outputs["ad"]
    check(d.shape == (1000,), f"adaptive: distances of shape {d.shape}")
    check(bool(np.all(np.isfinite(d))) and bool(np.all(np.diff(d) >= 0)),
          "adaptive: distances not finite and sorted")
    check(all(np.array_equal(r1.outputs[k], r2.outputs[k])
              for k in r1.outputs) and np.array_equal(w1[1], w2[1]),
          "adaptive: two runs with one seed differ")
    means = r1.sample_means_array
    check(bool(np.all((means > 0) & (means < 10))),
          f"adaptive: means {means} outside the prior")
    log(f"adaptive distance: {r1.n_batches} batches of 2**16 in {dt!r} s; "
        f"weights {w1[1].tolist()!r}; means {means.tolist()!r}; threshold "
        f"{float(d[-1])!r}; two runs with one seed equal")
    return dict(seconds=dt, means=means.tolist(), w=w1[1].tolist())


def weighted_means(res):
    w = res.weights / res.weights.sum()
    return np.array([float(np.sum(np.ravel(res.samples[k]) * w))
                     for k in res.samples])


def phase_smc_proposals(device):
    """Proposals and whole single-round runs: fused == batch at a time."""
    import elfi_tpu_torch as et
    from elfi_tpu_torch.methods.samplers import _GMProposals
    from elfi_tpu_torch.methods.utils import GMDistribution
    from elfi_tpu_torch.models import ma2, ma2_kernel
    from elfi_tpu_torch.utils import get_sub_seed
    from elfi_tpu_torch.utils.rng import fold_in, generator

    batch, wide = 2**14, np.diag([0.4, 0.3])
    smc = et.SMC(ma2.get_model(seed_obs=SEED_OBS)["d"], batch_size=batch,
                 seed=13, device=device)
    smc.sample(1000, quantiles=[0.5], bar=False)
    pop = smc._populations[-1]
    pop.meta["cov"] = wide         # wide enough that draws leave the prior
    smc.sample(1000, quantiles=[0.5], bar=False)      # round 1 from it
    proposal = GMDistribution.prepare(pop.means, wide, pop.weights,
                                      device=device)
    prior = smc._prior.traceable_logpdf()
    builder = _GMProposals(smc.parameter_names, batch, prior, proposal,
                               get_sub_seed(13, 1))
    key = fold_in(get_sub_seed(13, 1), 0x9E3779B9)
    for i in (3, 4):
        a, b = smc.prepare_new_batch(i), builder(i)
        check(all(torch.equal(a[k], b[k]) for k in ("t1", "t2")),
              f"SMC proposals of batch {i} differ between the two paths")
        x = torch.stack([a["t1"], a["t2"]], dim=1)
        check(bool(torch.isfinite(prior(x)).all()),
              "SMC proposals outside the prior support")
        first = GMDistribution._draw(proposal, batch,
                                     generator(fold_in(key, i), device))
        out = float((~torch.isfinite(prior(first))).float().mean())
        log(f"SMC proposals batch {i} of {batch}: prepare_new_batch == "
            f"fused builder bit for bit; first draw {out!r} outside the "
            "prior, redrawn")
        check(out > 0, "the wide mixture forced no redraw")
    for mod in (ma2, ma2_kernel):
        kw = dict(batch_size=500, seed=31, device=device)
        node = mod.get_model(seed_obs=SEED_OBS)["d"]
        a = et.SMC(node, **kw).sample(100, quantiles=[0.2], bar=False,
                                      fused=True)
        b = et.SMC(node, **kw).sample(100, quantiles=[0.2], bar=False,
                                      fused=False)
        for k in a.outputs:
            check(np.array_equal(a.outputs[k], b.outputs[k]),
                  f"{mod.__name__}: SMC fused and batch-at-a-time differ "
                  f"in {k}")
    log("SMC sample(100, quantiles=[0.2]): fused == batch-at-a-time on the "
        "card, both MA2 graphs")


def timed_smc(make, n_samples, **kw):
    """One SMC run from ``make()``; returns (result, seconds, sampler),
    the clock ended by a synchronise."""
    smc = make()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = smc.sample(n_samples, bar=False, **kw)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, smc


def phase_gauss_smc(device):
    """gauss2d SMC at the JAX bench's operating point."""
    import elfi_tpu_torch as et
    from elfi_tpu_torch.models import gauss
    m = gauss.get_model(**GAUSS_KW)
    obs_mean = np.asarray(m.observed["gauss"]).reshape(-1, 2).mean(0)

    def make(seed):
        return lambda: et.SMC(m["d"], batch_size=GAUSS_BATCH, seed=seed,
                              device=device)

    from elfi_tpu_torch.ops.kernels.topn import topn_cull
    timed_smc(make(3), GAUSS_N, thresholds=GAUSS_THRESHOLDS)    # warm-up
    reset_counts(topn_cull)
    res, dt, _ = timed_smc(make(4), GAUSS_N, thresholds=GAUSS_THRESHOLDS)
    cull = ran(topn_cull)
    means = weighted_means(res)
    err = np.abs(means - obs_mean)
    per_round = [int(p.meta["n_batches"]) for p in res.populations]
    d = res.discrepancies
    check(res.n_populations == 4, f"gauss2d SMC: {res.n_populations} rounds")
    check(res.samples_array.shape == (GAUSS_N, 2)
          and bool(np.all(np.isfinite(res.samples_array))),
          "gauss2d SMC: bad samples")
    check(bool(np.all(np.isfinite(res.weights)))
          and bool(np.all(res.weights >= 0)), "gauss2d SMC: bad weights")
    check(float(np.max(d)) <= GAUSS_THRESHOLDS[-1],
          f"gauss2d SMC: distance {float(np.max(d))} above the threshold")
    check(sum(per_round) == res.n_batches
          and res.n_sim == res.n_batches * GAUSS_BATCH,
          "gauss2d SMC: batch counts disagree")
    sims_s = res.n_sim / dt
    log(f"gauss2d SMC: weighted means {means.tolist()!r}, observed mean "
        f"{obs_mean.tolist()!r}, |err| {err.tolist()!r} (gate < {GATE})")
    log(f"gauss2d SMC: batch {GAUSS_BATCH}, batches per round {per_round}, "
        f"{res.n_sim} sims in {dt!r} s = {sims_s!r} sims/s; topn_cull "
        f"launches {cull}")
    check(bool(np.all(err < GATE)), f"gauss2d SMC gate failed: {means}")
    return dict(seconds=dt, n_sim=res.n_sim, sims_per_s=sims_s,
                n_batches=res.n_batches, batches_per_round=per_round,
                merge_launches=cull,
                means=means.tolist(), observed_mean=obs_mean.tolist())


def check_ma2_gate(name, res):
    means = weighted_means(res)
    err = np.abs(means - TRUE_PARAMS)
    check(bool(np.all(np.isfinite(res.samples_array))),
          f"{name}: non-finite samples")
    log(f"{name}: weighted means {means.tolist()!r} |err| {err.tolist()!r} "
        f"(gate < {GATE}); {res.n_populations} rounds, {res.n_batches} "
        f"batches, {res.n_sim} sims")
    check(bool(np.all(err < GATE)), f"{name}: MA2 gate failed: {means}")
    return means


def phase_ma2_smc(device):
    """SMC on both MA2 graphs; K1 runs once per batch on the kernel graph."""
    import elfi_tpu_torch as et
    from elfi_tpu_torch.methods.samplers import _FUSED_CHUNK
    from elfi_tpu_torch.models import ma2, ma2_kernel
    from elfi_tpu_torch.ops.kernels.ma2 import ma2_distance
    from elfi_tpu_torch.ops.kernels.topn import topn_cull
    out = {}
    for name, mod, kernel in (("ma2 smc plain graph", ma2, False),
                              ("ma2 smc kernel graph", ma2_kernel, True)):
        node = mod.get_model(seed_obs=SEED_OBS)["d"]
        reset_counts(ma2_distance, topn_cull)
        res, dt, smc = timed_smc(
            lambda: et.SMC(node, batch_size=SMC_BATCH, seed=3,
                           device=device),
            500, quantiles=[0.25, 0.25, 0.25])
        launches = ran(ma2_distance)
        cull = ran(topn_cull)
        means = check_ma2_gate(name, res)
        per_round = [int(p.meta["n_batches"]) for p in res.populations]
        # a captured proposal chunk whose batch needed a redraw round runs
        # again eagerly: its batches launch K1 twice
        redone = smc.state.get("redone_chunks", 0)
        expect = res.n_batches + redone * _FUSED_CHUNK if kernel else 0
        log(f"{name}: {dt!r} s, batches per round {per_round}; "
            f"ma2_distance launches {launches} (expected {expect}, "
            f"{redone} chunks run again); topn_cull launches {cull}")
        check(sum(per_round) == res.n_batches, f"{name}: batch counts")
        check(launches == expect, f"{name}: ma2_distance launched "
              f"{launches} times, expected {expect}")
        out[name] = dict(seconds=dt, launches=launches, merge_launches=cull,
                         means=means.tolist(), n_batches=res.n_batches,
                         batches_per_round=per_round, redone_chunks=redone)
    return out


def phase_adaptive_smc(device):
    """The adaptive SMC samplers on the plain MA2 graph."""
    import elfi_tpu_torch as et
    from elfi_tpu_torch.methods.density_ratio_estimation import \
        DensityRatioEstimation
    from elfi_tpu_torch.models import ma2
    out = {}
    node = ma2.get_model(seed_obs=SEED_OBS)["d"]
    res, dt, smc = timed_smc(lambda: et.AdaptiveThresholdSMC(
        node, batch_size=SMC_BATCH, seed=4, initial_quantile=0.25,
        densratio_estimation=DensityRatioEstimation(
            n=80, epsilon=0.001, max_iter=150, abs_tol=0.01, device=device),
        device=device), 400, max_iter=4)
    check(smc.densratio._alpha.device.type == "cuda",
          "the density-ratio fit did not run on the card")
    means = check_ma2_gate("AdaptiveThresholdSMC", res)
    quantiles = [q for q in smc.schedule.quantiles if q is not None]
    log(f"AdaptiveThresholdSMC: {dt!r} s; quantiles {quantiles!r}")
    out["AdaptiveThresholdSMC"] = dict(seconds=dt, means=means.tolist(),
                                       n_batches=res.n_batches)

    m = ma2.get_model(seed_obs=SEED_OBS)
    et.AdaptiveDistance(m["S1"], m["S2"], model=m, name="ad")
    res, dt, _ = timed_smc(lambda: et.AdaptiveDistanceSMC(
        m["ad"], batch_size=SMC_BATCH, seed=10, device=device), 500,
        rounds=3, quantile=0.25)
    check(len(res.adaptive_distance_w) == 3, "AdaptiveDistanceSMC: weights")
    means = check_ma2_gate("AdaptiveDistanceSMC", res)
    log(f"AdaptiveDistanceSMC: {dt!r} s")
    out["AdaptiveDistanceSMC"] = dict(seconds=dt, means=means.tolist(),
                                      n_batches=res.n_batches)
    return out


def sync_guarded(fn):
    """``fn`` run with every synchronisation of the host with the card
    raising an error (``torch.cuda.set_sync_debug_mode("error")``)."""
    def run(*args, **kwargs):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return run


def bsl_profile(bsl_run, n_steps):
    """(CUDA kernel and copy events, device microseconds, the averaged
    events, the profile) of one fused chain of ``n_steps`` steps."""
    _, prof = profiled(lambda: bsl_run(5, n_steps))
    events, device_us = device_table(prof)
    n_events = sum(e.count for e in card_events(events))
    return n_events, device_us, events, prof


def host_rows(events, prof):
    """(key, self host microseconds, calls) of a profile's averaged host
    events, less ``recorded``'s own: its step and primer annotations and
    the primer's host events (kineto events up to the primer's end)."""
    from torch.autograd import DeviceType
    from elfi_tpu_torch.utils.profiling import PRIMER_NAME
    kineto = prof.profiler.kineto_results.events()
    end = primer_end(kineto)
    less = {}
    for e in kineto:
        if (e.device_type() == DeviceType.CPU and e.name() != PRIMER_NAME
                and e.start_ns() <= end
                and not e.name().startswith("ProfilerStep")):
            us, n = less.get(e.name(), (0.0, 0))
            less[e.name()] = (us + e.duration_ns() / 1e3, n + 1)
    return [(e.key, e.self_cpu_time_total - less.get(e.key, (0.0, 0))[0],
             e.count - less.get(e.key, (0.0, 0))[1]) for e in events
            if e.device_type == DeviceType.CPU and e.key != PRIMER_NAME
            and not e.key.startswith("ProfilerStep")]


def phase_bsl():
    """BSL on MA2 at the JAX bench's point, with no ``device=`` anywhere: the
    fused chain, gated; its host syncs, launches, time per step and busy
    share; then the JAX package's fused-against-host test point."""
    import elfi_tpu_torch as et
    from elfi_tpu_torch.methods.bsl import (method, robust_likelihood,
                                            standard_likelihood,
                                            unbiased_likelihood)
    from elfi_tpu_torch.models import ma2
    from elfi_tpu_torch.ops.kernels.gnk import gnk_distance
    from elfi_tpu_torch.ops.kernels.ma2 import ma2_distance
    et.reset_client()
    m = ma2.get_model(seed_obs=SEED_OBS)
    warton = standard_likelihood(shrinkage="warton", penalty=0.3)

    def make(seed, likelihood=warton, n_sim_round=BSL_N_SIM_ROUND):
        return et.BSL(m, n_sim_round=n_sim_round, feature_names=["S1", "S2"],
                      likelihood=likelihood, seed=seed)

    def run(seed, n_steps=BSL_N, **kw):
        """(result, seconds of sample(), sampler) of one chain."""
        bsl = make(seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = bsl.sample(n_steps, **{**BSL_SAMPLE_KW, **kw})
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, bsl

    run(3)                                                     # warm-up
    # the guard fails on a sync: show that it does, then run the timed
    # chain's loop under it
    try:
        sync_guarded(lambda: torch.ones(1, device="cuda").item())()
        check(False, "set_sync_debug_mode('error') let .item() through")
    except RuntimeError:
        pass
    orig = method.BSL._fused_chain
    method.BSL._fused_chain = sync_guarded(orig)
    reset_counts(ma2_distance, gnk_distance)
    try:
        res, dt, bsl = run(4)
    finally:
        method.BSL._fused_chain = orig
    launches = {"ma2_distance": ran(ma2_distance),
                "gnk_distance": ran(gnk_distance)}
    means = res.sample_means_array
    err = np.abs(means - TRUE_PARAMS)
    check(bsl.device == torch.device("cuda", 0),
          f"BSL without device= ran on {bsl.device}")
    check(res.n_sim == BSL_N * BSL_N_SIM_ROUND and res.n_samples ==
          BSL_N - BSL_BURN_IN, f"BSL: n_sim {res.n_sim}, {res.n_samples}")
    check(bool(np.all(np.isfinite(res.samples_array))), "BSL: non-finite")
    log(f"ma2 bsl: chain means {means.tolist()!r} |err| {err.tolist()!r} "
        f"(gate < {BSL_GATE}); acceptance {res.acc_rate!r}; {BSL_N} steps "
        f"of {BSL_N_SIM_ROUND} sims in {dt!r} s on {bsl.device}, no host "
        f"sync inside the loop; launches {launches} (BSL reads S1, S2)")
    check(bool(np.all(err < BSL_GATE)), f"BSL gate failed: {means}")
    check(0.05 < res.acc_rate < 1.0, f"BSL acceptance {res.acc_rate}")
    check(launches == {"ma2_distance": 0, "gnk_distance": 0},
          f"BSL launched a distance kernel: {launches}")
    again, _, _ = run(4)
    other, _, _ = run(5)
    check(np.array_equal(again.samples_array, res.samples_array),
          "BSL: two chains with seed 4 differ")
    check(not np.array_equal(other.samples_array, res.samples_array),
          "BSL: the chains of seeds 4 and 5 are equal")

    # launches and device time of a step: two profiled chains, differenced
    def short(seed, n_steps):
        make(seed).sample(n_steps, **BSL_SAMPLE_KW)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    n1, us1, _, _ = bsl_profile(short, BSL_PROFILE_STEPS + 1)
    n2, us2, events, prof2 = bsl_profile(short, 2 * BSL_PROFILE_STEPS + 1)
    per_step = (n2 - n1) / BSL_PROFILE_STEPS
    device_ms = (us2 - us1) / 1e3 / BSL_PROFILE_STEPS
    wall_ms = dt * 1e3 / BSL_N
    (OUT_DIR / "profile_ma2_bsl.txt").write_text(events.table(
        sort_by="self_device_time_total", row_limit=40))
    (OUT_DIR / "profile_ma2_bsl_host.txt").write_text(events.table(
        sort_by="self_cpu_time_total", row_limit=40))
    log(f"ma2 bsl: {wall_ms!r} ms per step (wall), {per_step!r} device "
        f"launches and {device_ms!r} device ms per step, so the device is "
        f"busy {device_ms / wall_ms!r} of it; tables by device and by host "
        f"time in build/profiles/profile_ma2_bsl{{,_host}}.txt")
    log_top(events, us2, 2 * BSL_PROFILE_STEPS + 1)
    rows = host_rows(events, prof2)
    host_us = sum(us for _, us, _ in rows)
    n_profiled = 2 * BSL_PROFILE_STEPS + 1
    for key, us, calls in sorted(rows, key=lambda r: -r[1])[:5]:
        log(f"  host, profiled: {us / 1e3 / n_profiled:.4f} ms/step "
            f"({us / host_us:.3f}, {calls} calls) {key[:60]}")

    # tests/functional/test_bsl.py TestFusedBSL._run: fused against host
    point = dict(sigma_proposals=np.diag([.05, .05]),
                 params0=np.array([[.6, .2]]), burn_in=20, bar=False)
    fused = make(4, None, 300).sample(120, fused=True, **point)
    host = make(4, None, 300).sample(120, fused=False, **point)
    gap = np.abs(fused.sample_means_array - host.sample_means_array)
    log(f"ma2 bsl, 120 steps of 300: fused means "
        f"{fused.sample_means_array.tolist()!r}, host "
        f"{host.sample_means_array.tolist()!r}, |gap| {gap.tolist()!r} "
        f"(< 0.15)")
    check(bool(np.all(gap < 0.15)), "BSL: fused and host chains disagree")
    unbiased = make(4, unbiased_likelihood(), 300).sample(
        120, fused=True, **point)
    check(bool(np.all(np.isfinite(unbiased.samples_array))),
          "BSL: the unbiased fused chain is not finite")
    robust = make(4, robust_likelihood("mean"), 300).sample(5, **point)
    check(robust.samples_all["gamma"].shape == (5, 2)
          and bool(np.all(np.isfinite(robust.samples_all["gamma"]))),
          "BSL: the robust host chain")
    log(f"ma2 bsl: unbiased fused means "
        f"{unbiased.sample_means_array.tolist()!r}; robust ('mean') host "
        f"chain of 5 steps, gammas finite")
    return dict(seconds=dt, ms_per_step=wall_ms, n_steps=BSL_N,
                n_sim=res.n_sim, means=means.tolist(),
                acc_rate=res.acc_rate, launches=launches,
                launches_per_step=per_step, device_ms_per_step=device_ms,
                busy_share=device_ms / wall_ms, device=str(bsl.device),
                fused_host_gap=gap.tolist())


def ricker_bolfi_model():
    """The JAX bench's Ricker model (``bench.py:_bench_bolfi_ricker``) on
    the JAX package's observed series of key 4."""
    import elfi_tpu_torch as et
    from elfi_tpu_torch.models import ricker
    m = et.Model(name="ricker_bolfi")
    et.Prior("uniform", 3, 2, model=m, name="t1")
    et.Prior("uniform", 0.05, 0.75, model=m, name="t2")
    et.Prior("uniform", 4, 12, model=m, name="t3")
    et.Simulator(partial(ricker.stochastic_ricker, n_obs=50),
                 m["t1"], m["t2"], m["t3"], observed=ricker.bench_observed(),
                 model=m, name="Ricker")
    s1 = et.Summary(ricker.mean, m["Ricker"], model=m, name="Mean")
    s2 = et.Summary(ricker.var, m["Ricker"], model=m, name="Var")
    s3 = et.Summary(ricker.num_zeros, m["Ricker"], model=m, name="n0")
    et.Discrepancy(ricker.chi_squared, s1, s2, s3, model=m, name="d")
    et.Operation(torch.log, m["d"], model=m, name="log_d")
    return m


#: host calls that put work on the card: each has at least one device
#: record (a kernel, a copy or a memset; a graph replay runs many)
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                "cudaMemsetAsync")
#: the kernel of ``utils.profiling.recorded``'s primer (``torch.cuda._sleep``)
PRIMER_KERNEL = "spin_kernel"


def profile_counts(prof):
    """(host launch calls, device kernels, device microseconds) of a
    profile: a graph replay is one launch call and runs many kernels."""
    events, device_us = device_table(prof)
    launch_calls = len(block_launches(prof.profiler.kineto_results.events()))
    kernels = sum(e.count for e in card_events(events))
    return launch_calls, kernels, device_us, events


def primer_end(events):
    """The host time (ns) at which ``recorded``'s primer ends among a
    profile's kineto events, 0 without one."""
    from torch.autograd import DeviceType
    from elfi_tpu_torch.utils.profiling import PRIMER_NAME
    return max((e.start_ns() + e.duration_ns() for e in events
                if e.name() == PRIMER_NAME
                and e.device_type() == DeviceType.CPU), default=0)


def block_launches(events):
    """A profile's host launches (kineto events) after ``recorded``'s
    primer: those of the profiled block."""
    end = primer_end(events)
    return [e for e in events
            if e.name() in LAUNCH_CALLS and e.start_ns() > end]


def profiled(fn):
    """(fn's result, its profile) through ``utils.profiling.recorded``: the
    recording starts after a warm-up step, the card is synchronised around
    ``fn`` and the window held open at each end.  Fails unless every host
    launch of the profile has its device record."""
    from elfi_tpu_torch.utils.profiling import recorded
    torch.cuda.synchronize()
    with recorded() as prof:
        out = fn()
    check_complete(prof.profiler.kineto_results.events(), "the profile")
    return out, prof


def executed_launches(events):
    """Correlation ids of the profiled block's host launches that ran on
    the card: those made while a stream was captured into a CUDA graph only
    record their work (it runs, and is traced, when the graph is
    replayed)."""
    begins = sorted(e.start_ns() for e in events
                    if e.name().startswith("cudaStreamBeginCapture"))
    ends = sorted(e.start_ns() for e in events
                  if e.name().startswith("cudaStreamEndCapture"))
    spans = list(zip(begins, ends))
    return [e.correlation_id() for e in block_launches(events)
            if not any(b <= e.start_ns() <= f for b, f in spans)]


def check_complete(events, what):
    """Fail unless every host launch among a profile's kineto events that
    ran on the card has a device record, matched by CUPTI correlation id
    (one id a launch)."""
    from torch.autograd import DeviceType
    launches = executed_launches(events)
    on_device = {e.correlation_id() for e in events
                 if e.device_type() == DeviceType.CUDA}
    lost = set(launches) - on_device
    check(len(set(launches)) == len(launches) and not lost,
          f"{what} lost the device records of {len(lost)} of its "
          f"{len(launches)} host launches ({len(set(launches))} ids)")


def nuts_per_iteration(target, args, x0s, widths, table):
    """(host launch calls, device kernels, device ms, steps, kernels a
    step) per NUTS iteration of all chains: two profiled runs of the target
    from ``x0s``, of NUTS_PROFILE_ITERS and twice as many iterations,
    differenced; the longer run's table goes to build/profiles/."""
    from elfi_tpu_torch.methods import mcmc

    def nuts_run(n_iter):
        return mcmc.nuts_chains(n_iter, x0s, target, seed=1,
                                target_args=args, scales=widths)
    _, p1 = profiled(lambda: nuts_run(NUTS_PROFILE_ITERS))
    s1 = dict(mcmc.stats)
    _, p2 = profiled(lambda: nuts_run(2 * NUTS_PROFILE_ITERS))
    s2 = dict(mcmc.stats)
    c1, k1, us1, _ = profile_counts(p1)
    c2, k2, us2, events = profile_counts(p2)
    (OUT_DIR / f"{table}.txt").write_text(events.table(
        sort_by="self_device_time_total", row_limit=40))
    steps = s2["steps"] - s1["steps"]
    return ((c2 - c1) / NUTS_PROFILE_ITERS, (k2 - k1) / NUTS_PROFILE_ITERS,
            (us2 - us1) / 1e3 / NUTS_PROFILE_ITERS, steps / NUTS_PROFILE_ITERS,
            (k2 - k1) / max(steps, 1))


def phase_bolfi():
    """BOLFI at the JAX bench's Ricker point with no ``device=`` anywhere,
    gated against a rejection ground truth; its walls, launches, device time
    and busy share; one segment with no host sync; then the JAX accuracy
    gate's MA2 point and the host loop."""
    import elfi_tpu_torch as et
    from elfi_tpu_torch.methods import bolfi as bolfi_mod
    from elfi_tpu_torch.methods import mcmc
    from elfi_tpu_torch.methods.bo import utils as bo_utils
    from elfi_tpu_torch.models import ma2
    from elfi_tpu_torch.ops.kernels.gnk import gnk_distance
    from elfi_tpu_torch.ops.kernels.ma2 import ma2_distance
    et.reset_client()
    k_before = (ran(ma2_distance), ran(gnk_distance))
    m = ricker_bolfi_model()
    names = ("t1", "t2", "t3")

    t0 = time.perf_counter()
    gt = et.Rejection(m["d"], batch_size=RICKER_GT_BATCH, seed=9).sample(
        2000, n_sim=RICKER_GT_N_SIM, bar=False)
    gt_s = time.perf_counter() - t0
    gt_means = np.array([float(np.mean(gt.samples[k])) for k in names])
    gt_sds = np.array([float(np.std(gt.samples[k])) for k in names])
    gt_gap = np.abs(gt_means - RICKER_JAX_GT_MEANS) / RICKER_JAX_GT_SDS
    log(f"ricker ground truth: rejection of {RICKER_GT_N_SIM} sims in "
        f"{gt_s!r} s, means {gt_means.tolist()!r} sds {gt_sds.tolist()!r}; "
        f"JAX means {RICKER_JAX_GT_MEANS.tolist()!r}, gap "
        f"{gt_gap.tolist()!r} JAX SDs (< {RICKER_GT_GATE})")
    check(bool(np.all(gt_gap < RICKER_GT_GATE)),
          "Ricker: the port's ground truth is off the JAX package's")

    def run(seed, guard=False):
        """(sample, fit seconds, sample seconds, BOLFI, descents replayed
        in the fused loop) of one bench run."""
        bolfi = et.BOLFI(m["log_d"], seed=seed, **RICKER_FIT)
        orig = bolfi_mod.BOLFI._fused_segment
        if guard:
            bolfi_mod.BOLFI._fused_segment = sync_guarded(orig)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            replays0 = bo_utils.replays
            bolfi.fit(n_evidence=RICKER_N_EVIDENCE, bar=False)
            replays = bo_utils.replays - replays0
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        finally:
            bolfi_mod.BOLFI._fused_segment = orig
        res = bolfi.sample(RICKER_N_SAMPLES, n_chains=4, bar=False)
        t2 = time.perf_counter()
        log(f"ricker bolfi, seed {seed}: fit {t1 - t0!r} s, sample "
            f"{t2 - t1!r} s")
        return res, t1 - t0, t2 - t1, bolfi, replays

    # the warm-up, with one segment and one refit profiled (each a replay
    # of a captured descent): launches and device time per acquisition and
    # per refit
    # and the wall of the others (the card synchronised around each)
    seg_prof, refit_prof = {}, {}
    walls = dict(segments=0.0, seg_acq=0, refits=0.0, n_refits=0)
    orig_segment = bolfi_mod.BOLFI._fused_segment
    orig_loop_fns = bolfi_mod._make_gp_loop_fns

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def segment(self, select, sim_fn, u_to_params, Xc, yc, u, n, ts, betas):
        def call():
            return orig_segment(self, select, sim_fn, u_to_params, Xc, yc,
                                u, n, ts, betas)
        if seg_prof or ts.start == 0:
            n, dt = timed(call)
            if ts.start:
                walls["segments"] += dt
                walls["seg_acq"] += len(ts)
            return n
        seg_prof["n_acq"] = len(ts)
        n, seg_prof["prof"] = profiled(call)
        return n

    def loop_fns(*a, **kw):
        heuristic, u_to_params, init_fit, refit = orig_loop_fns(*a, **kw)

        def refit_once(*args):
            # the first refit captures its descent: profile the second
            if "first_refit" not in walls:
                u, walls["first_refit"] = timed(lambda: refit(*args))
                return u
            if refit_prof:
                u, dt = timed(lambda: refit(*args))
                walls["refits"] += dt
                walls["n_refits"] += 1
                return u
            u, refit_prof["prof"] = profiled(lambda: refit(*args))
            return u
        return heuristic, u_to_params, init_fit, refit_once

    bolfi_mod.BOLFI._fused_segment = segment
    bolfi_mod._make_gp_loop_fns = loop_fns
    try:
        run(2)
    finally:
        bolfi_mod.BOLFI._fused_segment = orig_segment
        bolfi_mod._make_gp_loop_fns = orig_loop_fns
    acq_calls, acq_kernels, acq_us, acq_events = profile_counts(
        seg_prof["prof"])
    n_acq_prof = seg_prof["n_acq"]
    refit_calls, refit_kernels, refit_us, refit_events = profile_counts(
        refit_prof["prof"])
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "profile_bolfi_segment.txt").write_text(acq_events.table(
        sort_by="self_device_time_total", row_limit=40))
    (OUT_DIR / "profile_bolfi_refit.txt").write_text(refit_events.table(
        sort_by="self_device_time_total", row_limit=40))

    # the timed run, its segments under the sync guard
    res, fit_s, sample_s, bolfi, replays = run(1, guard=True)
    nuts_stats = dict(mcmc.stats)
    means = res.sample_means_array
    dev = np.abs(means - gt_means) / gt_sds
    n_acq = RICKER_N_EVIDENCE - RICKER_FIT["initial_evidence"]
    _, segments = bolfi_mod.refit_schedule(
        RICKER_FIT["initial_evidence"], RICKER_N_EVIDENCE,
        RICKER_FIT["update_interval"])
    n_refits = sum(1 for s in segments if s[2])
    iters = nuts_stats["iterations"]
    mean_depth = nuts_stats["depth_sum"] / (nuts_stats["chains"] * iters)
    check(bolfi.device == torch.device("cuda", 0),
          f"BOLFI without device= ran on {bolfi.device}")
    check(bolfi.target_model.n_evidence == RICKER_N_EVIDENCE,
          "BOLFI: wrong evidence count")
    check(res.chains.shape == (4, RICKER_N_SAMPLES, 3)
          and bool(np.all(np.isfinite(res.chains))), "BOLFI: bad chains")
    # one captured descent a step: each acquisition, the initial GP fit,
    # each refit and the posterior's threshold
    check(replays == n_acq + 1 + n_refits + 1, f"BOLFI: {replays} "
          f"descents replayed for {n_acq} acquisitions and {n_refits} "
          "refits")
    ess = {k: float(v) for k, v in bolfi.ess.items()}
    rhat = {k: float(v) for k, v in bolfi.rhat.items()}
    log(f"ricker bolfi, seed 1: means {means.tolist()!r}, |mean - gt| "
        f"{dev.tolist()!r} gt SDs (gate < {RICKER_GATE_SDS}); ESS {ess!r}, "
        f"R-hat {rhat!r}; threshold {res.threshold!r}")
    log(f"ricker bolfi: fit({RICKER_N_EVIDENCE}) {fit_s!r} s wall, "
        f"sample({RICKER_N_SAMPLES}, n_chains=4) {sample_s!r} s wall; "
        f"{n_acq} acquisitions, {n_refits} refits; segments ran under "
        f"set_sync_debug_mode('error')")
    check(bool(np.all(dev < RICKER_GATE_SDS)),
          f"BOLFI Ricker gate failed: {means} against {gt_means}")

    # NUTS launches and device time per iteration: two profiled runs of
    # the timed posterior, differenced
    post = bolfi.extract_posterior()
    target, args = post.traceable_logpdf_args()
    x0s = res.chains[:, -1, :]
    widths = np.asarray([hi - lo for lo, hi in RICKER_BOUNDS.values()],
                        np.float32)

    it_calls, it_kernels, it_ms, steps_per_it, kernels_per_step = \
        nuts_per_iteration(target, args, x0s, widths, "profile_bolfi_nuts")

    acq_ms = acq_us / 1e3 / n_acq_prof
    refit_ms = refit_us / 1e3
    device_s = (n_acq * acq_ms + n_refits * refit_ms + iters * it_ms) / 1e3
    busy = device_s / (fit_s + sample_s)
    log(f"ricker bolfi, acquisition: {acq_calls / n_acq_prof!r} host launch "
        f"calls, {acq_kernels / n_acq_prof!r} device kernels and "
        f"{acq_ms!r} device ms each (one segment of {n_acq_prof}, profiled); "
        f"refit: {refit_calls} launch calls, {refit_kernels} kernels, "
        f"{refit_ms!r} device ms")
    log(f"ricker bolfi, NUTS: {it_calls!r} host launch calls, "
        f"{it_kernels!r} device kernels and {it_ms!r} device ms per "
        f"iteration of 4 chains ({steps_per_it!r} steps of "
        f"{kernels_per_step!r} kernels); mean tree depth {mean_depth!r}, "
        f"{nuts_stats['leapfrogs'] / (4 * iters)!r} leapfrogs per chain "
        f"iteration, {nuts_stats['steps']} steps, captured "
        f"{nuts_stats['captured']}")
    log(f"ricker bolfi: device busy {busy!r} of the timed run's wall "
        f"({device_s!r} s of device time from the per-acquisition, "
        f"per-refit and per-iteration profiles); tables in "
        f"build/profiles/profile_bolfi_{{segment,refit,nuts}}.txt")
    log_top(acq_events, acq_us, n_acq_prof)
    log(f"ricker bolfi, warm-up walls (synchronised): "
        f"{walls['segments'] / walls['seg_acq'] * 1e3!r} ms an acquisition "
        f"over {walls['seg_acq']}, {walls['refits'] / walls['n_refits']!r} s "
        f"a refit over {walls['n_refits']} (the first, which captures, "
        f"{walls['first_refit']!r} s)")

    # one refit at the full point, eager and replayed: the same result
    gp = bolfi.target_model
    Xp, yp, mask = gp._padded()
    u0 = gp._log_param_vector().astype(np.float32)
    starts = torch.as_tensor(np.vstack(
        [u0] + [u0 + 0.5 * np.random.RandomState(i).randn(4)
                for i in range(3)]).astype(np.float32), device=Xp.device)
    shapes = torch.as_tensor(gp._prior_shapes, dtype=torch.float32,
                             device=Xp.device)

    def refit_call(capture):
        return gp.fns.optimize_restarts_core(
            starts, Xp, yp, mask, shapes, torch.tensor(0.1, device=Xp.device),
            steps=120, const_params=gp._const_params(), capture=capture)
    eager, eager_s = timed(lambda: refit_call(False))
    replayed, replay_s = timed(lambda: refit_call(True))
    check(all(torch.equal(a, b) for a, b in zip(eager, replayed)),
          "BOLFI: the replayed refit differs from the eager one")
    log(f"ricker bolfi, one refit of 4 restarts x 120 steps at cap 512: "
        f"eager {eager_s!r} s, replayed {replay_s!r} s, equal bit for bit")
    walls.update(refit_eager_s=eager_s, refit_replay_s=replay_s)

    again, _, _, _, _ = run(1)
    check(np.array_equal(again.chains, res.chains),
          "BOLFI: two runs with seed 1 differ")

    # the JAX accuracy gate's MA2 point, fused
    m6 = ma2.get_model(seed_obs=SEED_OBS)
    et.Operation(torch.log, m6["d"], model=m6, name="log_d")
    t0 = time.perf_counter()
    ma2_bolfi = et.BOLFI(m6["log_d"], seed=5, **BOLFI_MA2_FIT)
    ma2_bolfi.fit(n_evidence=120, bar=False)
    ma2_res = ma2_bolfi.sample(1200, n_chains=4, bar=False)
    ma2_s = time.perf_counter() - t0
    ma2_means = ma2_res.sample_means_array
    ma2_err = np.abs(ma2_means - TRUE_PARAMS)
    log(f"ma2 bolfi, seed 5: means {ma2_means.tolist()!r} |err| "
        f"{ma2_err.tolist()!r} (gate < {BOLFI_MA2_GATE}) in {ma2_s!r} s")
    check(bool(np.all(ma2_err < BOLFI_MA2_GATE)),
          f"BOLFI MA2 gate failed: {ma2_means}")

    # the host loop at the MA2 point
    host = et.BOLFI(m6["log_d"], seed=5, **BOLFI_MA2_FIT)
    host_post = host.fit(n_evidence=40, bar=False, fused=False)
    x_min = host.extract_result().x_min
    inside = all(lo <= float(x_min[k][0]) <= hi for k, (lo, hi) in
                 BOLFI_MA2_FIT["bounds"].items())
    log(f"ma2 bolfi, host loop to 40: threshold {host_post.threshold!r}, "
        f"x_min {({k: float(v[0]) for k, v in x_min.items()})!r}")
    check(np.isfinite(host_post.threshold) and inside,
          "BOLFI host loop: bad threshold or x_min")
    k_after = (ran(ma2_distance), ran(gnk_distance))
    check(k_after == k_before, f"BOLFI launched a distance kernel: K1, K2 "
          f"counts {k_before} before the phase, {k_after} after")
    return dict(fit_s=fit_s, sample_s=sample_s, means=means.tolist(),
                gt_means=gt_means.tolist(), gt_sds=gt_sds.tolist(),
                gap_sds=dev.tolist(), ess=ess, rhat=rhat,
                acq_launch_calls=acq_calls / n_acq_prof,
                acq_kernels=acq_kernels / n_acq_prof, acq_device_ms=acq_ms,
                refit_device_ms=refit_ms, refit_kernels=refit_kernels,
                nuts_launch_calls_per_iter=it_calls,
                nuts_kernels_per_iter=it_kernels,
                nuts_device_ms_per_iter=it_ms, mean_tree_depth=mean_depth,
                busy_share=busy, warmup_walls=walls,
                ma2_means=ma2_means.tolist(),
                ma2_seconds=ma2_s, device=str(bolfi.device))


@functools.cache
def gnk_ground_truth():
    """The g-and-k benches' ground truth, computed once: rejection over
    2**20 simulations of the plain graph (batch 2**14, seed 8,
    ``bench.py:217-220`` and ``:259-262``), with no ``device=``; its means
    must be within ``GNK_GATE`` of the JAX package's for the same call."""
    import elfi_tpu_torch as et
    from elfi_tpu_torch.models import gnk
    t0 = time.perf_counter()
    gt_m = gnk.get_model(n_obs=GNK_N_OBS, seed_obs=GNK_SEED_OBS)
    gt = et.Rejection(gt_m["d"], batch_size=BOLFIRE_GT_BATCH, seed=8).sample(
        1000, n_sim=BOLFIRE_GT_N_SIM, bar=False)
    gt_s = time.perf_counter() - t0
    gt_means = np.array([float(np.mean(gt.samples[k])) for k in GNK_NAMES])
    gt_gap = np.abs(gt_means - BOLFIRE_JAX_GT_MEANS)
    log(f"gnk ground truth: rejection of {BOLFIRE_GT_N_SIM} sims in "
        f"{gt_s!r} s, means {gt_means.tolist()!r}; JAX means "
        f"{BOLFIRE_JAX_GT_MEANS.tolist()!r}, |gap| {gt_gap.tolist()!r} "
        f"(< {GNK_GATE.tolist()})")
    check(bool(np.all(gt_gap < GNK_GATE)),
          "the port's g-and-k ground truth is off the JAX package's")
    return gt_means


def bolfire_gnk_model():
    """The JAX bench's g-and-k model with the squared-octile summary
    (``bench.py:_bench_bolfire_gnk``)."""
    import elfi_tpu_torch as et
    from elfi_tpu_torch.models import gnk
    m = gnk.get_model(n_obs=GNK_N_OBS, seed_obs=GNK_SEED_OBS)
    et.Summary(gnk.ss_octile_sq, m["GNK"], model=m, name="ss_osq")
    return m


def check_bolfire_fit(name, bolfire, n, bounds):
    """A fit of ``n`` rounds: finite evidence in the bounds and one set of
    classifier attributes a round."""
    gp = bolfire.target_model
    lo = np.array([b[0] for b in bounds.values()])
    hi = np.array([b[1] for b in bounds.values()])
    check(gp.n_evidence == n and len(bolfire.classifier_attributes) == n,
          f"{name}: {gp.n_evidence} evidence, "
          f"{len(bolfire.classifier_attributes)} classifier attributes")
    check(bool(np.all(np.isfinite(gp.X)) and np.all(np.isfinite(gp.Y))
               and np.all((gp.X >= lo) & (gp.X <= hi))),
          f"{name}: evidence not finite or outside the bounds")


def phase_bolfire():
    """BOLFIRE at the JAX bench's g-and-k point with no ``device=``
    anywhere, gated as the bench gates it against a rejection ground truth;
    its walls, launches and device time per classifier round, acquisition
    and refit, and its busy share; the segments with no host sync; then
    the JAX test points, fused and on the host."""
    import elfi_tpu_torch as et
    from elfi_tpu_torch.methods import bolfire as bolfire_mod
    from elfi_tpu_torch.models import gnk, ma2
    from elfi_tpu_torch.ops.kernels.gnk import gnk_distance
    from elfi_tpu_torch.ops.kernels.ma2 import ma2_distance
    from elfi_tpu_torch.utils.rng import fold_in
    et.reset_client()
    k_before = (ran(ma2_distance), ran(gnk_distance))
    m = bolfire_gnk_model()

    gt_means = gnk_ground_truth()

    orig_programs = bolfire_mod._fused_bolfire_programs
    orig_segment = bolfire_mod.BOLFIRE._fused_segment
    seen = {}

    def programs(*a, **kw):
        # keep the warm-up's programs and state, to profile their parts
        progs = orig_programs(*a, **kw)

        def init_run(*args):
            out = progs.init_run(*args)
            seen["init_args"], seen["shapes"] = args, out[3]
            return out
        seen["progs"] = progs
        return progs._replace(init_run=init_run)

    def segment(self, progs, Xc, yc, u, n, ts, betas, marginal, obs, coefs):
        seen["state"] = (Xc, yc, u, betas, marginal, obs)
        return orig_segment(self, progs, Xc, yc, u, n, ts, betas, marginal,
                            obs, coefs)

    def run(seed, guard=False):
        """(sample, construction s, fit s, sample s, BOLFIRE) of one bench
        run."""
        t0 = time.perf_counter()
        bolfire = et.BOLFIRE(m, seed=seed, **BOLFIRE_FIT)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if guard:
            bolfire_mod.BOLFIRE._fused_segment = sync_guarded(orig_segment)
        try:
            bolfire.fit(n_evidence=BOLFIRE_N_EVIDENCE, bar=False)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        finally:
            bolfire_mod.BOLFIRE._fused_segment = orig_segment
        res = bolfire.sample(BOLFIRE_N_SAMPLES, n_chains=4, bar=False)
        t3 = time.perf_counter()
        log(f"gnk bolfire, seed {seed}: construction {t1 - t0!r} s, fit "
            f"{t2 - t1!r} s, sample {t3 - t2!r} s")
        return res, t1 - t0, t2 - t1, t3 - t2, bolfire

    bolfire_mod._fused_bolfire_programs = programs
    bolfire_mod.BOLFIRE._fused_segment = segment
    try:
        run(2)
    finally:
        bolfire_mod._fused_bolfire_programs = orig_programs
        bolfire_mod.BOLFIRE._fused_segment = orig_segment

    # the parts of the warm-up's fit, each on its last state: the initial
    # run, an acquisition, a classifier round and a refit
    progs = seen["progs"]
    Xc, yc, u, betas, marginal, obs = seen["state"]
    n_init = BOLFIRE_FIT["n_initial_evidence"]
    n_acq = BOLFIRE_N_EVIDENCE - n_init
    n, t = BOLFIRE_N_EVIDENCE - 1, n_acq - 1
    params = progs.u_to_params(u)
    theta = progs.select(fold_in(2, 0x5EED), Xc, yc, n, params, t, betas[t])

    def acquisition():
        return progs.select(fold_in(2, 0x5EED), Xc, yc, n, params, t,
                            betas[t])

    def rounds():
        for _ in range(BOLFIRE_PROFILE_ROUNDS):
            progs.neg_log_ratio(progs.features_at(2, n_init + t, theta),
                                marginal, obs)

    def refit():
        return progs.refit_run(2, Xc, yc, u, seen["shapes"], n, t)

    parts = {}
    for name, fn, count in (("init", lambda: progs.init_run(
                                 *seen["init_args"]), 1),
                            ("acquisition", acquisition, 1),
                            ("round", rounds, BOLFIRE_PROFILE_ROUNDS),
                            ("refit", refit, 1)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / count
        _, prof = profiled(fn)
        calls, kernels, us, events = profile_counts(prof)
        (OUT_DIR / f"profile_bolfire_{name}.txt").write_text(events.table(
            sort_by="self_device_time_total", row_limit=40))
        parts[name] = dict(launch_calls=calls / count,
                           kernels=kernels / count,
                           device_ms=us / 1e3 / count, wall_ms=wall_ms)
        log(f"gnk bolfire, {name}: {calls / count!r} host launch calls, "
            f"{kernels / count!r} device kernels, {us / 1e3 / count!r} "
            f"device ms and {wall_ms!r} wall ms each (synchronised; table "
            f"in build/profiles/profile_bolfire_{name}.txt)")
        if name == "round":
            log_top(events, us, count)

    # the timed run, its segments under the sync guard
    res, init_s, fit_s, sample_s, bolfire = run(1, guard=True)
    check(bolfire.device == torch.device("cuda", 0),
          f"BOLFIRE without device= ran on {bolfire.device}")
    check_bolfire_fit("gnk bolfire", bolfire, BOLFIRE_N_EVIDENCE,
                      BOLFIRE_FIT["bounds"])
    check(res.chains.shape == (4, BOLFIRE_N_SAMPLES, 4)
          and bool(np.all(np.isfinite(res.chains))), "BOLFIRE: bad chains")
    means = res.sample_means_array
    a_sd = float(np.std(np.ravel(res.samples["A"])))
    prior_sd = 10.0 / math.sqrt(12.0)
    _, segments = bolfire_mod.refit_schedule(
        n_init, BOLFIRE_N_EVIDENCE, BOLFIRE_FIT["update_interval"])
    n_refits = sum(1 for s in segments if s[2])
    log(f"gnk bolfire, seed 1: means {means.tolist()!r} (ground truth "
        f"{gt_means.tolist()!r}); |A - gt A| {abs(means[0] - gt_means[0])!r} "
        f"(< {BOLFIRE_A_GATE}), A's sd {a_sd!r} (< {BOLFIRE_SD_SHARE} x the "
        f"prior's {prior_sd!r}); fit({BOLFIRE_N_EVIDENCE}) {fit_s!r} s "
        f"wall, sample({BOLFIRE_N_SAMPLES}, n_chains=4) {sample_s!r} s wall; "
        f"{n_acq} acquisitions, {n_refits} refits; segments ran under "
        "set_sync_debug_mode('error')")
    check(abs(means[0] - gt_means[0]) < BOLFIRE_A_GATE
          and a_sd < BOLFIRE_SD_SHARE * prior_sd
          and bool(np.all(np.isfinite(means)))
          and bool(np.all((means >= 0.0) & (means <= 10.0))),
          f"BOLFIRE gate failed: means {means}, A's sd {a_sd}")

    post = bolfire.extract_result()
    target, args = post.traceable_logpdf_args()
    widths = np.full(4, 10.0, np.float32)
    it_calls, it_kernels, it_ms, steps_per_it, kernels_per_step = \
        nuts_per_iteration(target, args, res.chains[:, -1, :], widths,
                           "profile_bolfire_nuts")
    device_s = (parts["init"]["device_ms"]
                + n_acq * (parts["acquisition"]["device_ms"]
                           + parts["round"]["device_ms"])
                + n_refits * parts["refit"]["device_ms"]
                + BOLFIRE_N_SAMPLES * it_ms) / 1e3
    busy = device_s / (fit_s + sample_s)
    log(f"gnk bolfire, NUTS: {it_calls!r} host launch calls, {it_kernels!r} "
        f"device kernels and {it_ms!r} device ms per iteration of 4 chains "
        f"({steps_per_it!r} steps of {kernels_per_step!r} kernels)")
    log(f"gnk bolfire: device busy {busy!r} of the timed run's fit and "
        f"sample walls ({device_s!r} s of device time from the profiled "
        "parts)")

    again = run(1)[0]
    check(np.array_equal(again.chains, res.chains),
          "BOLFIRE: two runs with seed 1 differ")

    # the JAX package's test points: g-and-k fused and on the host, and
    # MA2, whose triangle prior adds the cost and the prior-program draws
    points = {}
    for fused in (True, False):
        small = et.BOLFIRE(gnk.get_model(n_obs=50, seed_obs=2),
                           n_training_data=100, feature_names=["ss_order"],
                           bounds=BOLFIRE_FIT["bounds"], n_initial_evidence=8,
                           seed=5)
        t0 = time.perf_counter()
        small.fit(n_evidence=12, bar=False, fused=fused)
        name = "gnk test point " + ("fused" if fused else "host")
        points[name] = time.perf_counter() - t0
        check_bolfire_fit(name, small, 12, BOLFIRE_FIT["bounds"])
    ma2_bounds = {"t1": (-2, 2), "t2": (-1, 1)}
    small = et.BOLFIRE(ma2.get_model(seed_obs=4), n_training_data=100,
                       batch_size=100, bounds=ma2_bounds,
                       n_initial_evidence=5, update_interval=5, seed=11)
    check(small._fused_eligible() and small._fused_box() is None,
          "BOLFIRE MA2: not the fused path with the prior cost")
    t0 = time.perf_counter()
    small.fit(n_evidence=12, bar=False)
    points["ma2 test point fused"] = time.perf_counter() - t0
    check_bolfire_fit("ma2 test point", small, 12, ma2_bounds)
    check(bool(np.all(np.isfinite(small.prior.logpdf(
        small.target_model.X)))), "BOLFIRE MA2: evidence outside the prior")
    log(f"bolfire test points: fits of 12 rounds, finite, in bounds, 12 "
        f"classifier attributes each; seconds {points!r}")

    k_after = (ran(ma2_distance), ran(gnk_distance))
    check(k_after == k_before, f"BOLFIRE launched a distance kernel: K1, "
          f"K2 counts {k_before} before the phase, {k_after} after")
    log(f"gnk bolfire: K1, K2 launch counts {k_after} before and after the "
        "phase (neither launched)")
    return dict(construction_s=init_s, fit_s=fit_s, sample_s=sample_s,
                means=means.tolist(), gt_means=gt_means.tolist(),
                a_sd=a_sd, parts=parts, nuts_launch_calls_per_iter=it_calls,
                nuts_kernels_per_iter=it_kernels,
                nuts_device_ms_per_iter=it_ms,
                nuts_steps_per_iter=steps_per_it,
                busy_share=busy, test_points_s=points,
                device=str(bolfire.device))


def phase_variance_acquisitions():
    """BOLFI's host loop on MA2 with each variance acquisition through the
    entry point, with no ``device=``: the acquired points in the bounds,
    the GP finite, and the wall of one more acquisition of each."""
    import elfi_tpu_torch as et
    from elfi_tpu_torch.methods.bo import acquisition as acq_mod
    from elfi_tpu_torch.models import ma2
    et.reset_client()
    m = ma2.get_model(seed_obs=SEED_OBS)
    et.Operation(torch.log, m["d"], model=m, name="log_d")
    bounds = BOLFI_MA2_FIT["bounds"]
    out = {}
    for cls_name in ("MaxVar", "RandMaxVar", "ExpIntVar"):
        gp = et.GPRegression(["t1", "t2"], bounds=bounds)
        acq = getattr(acq_mod, cls_name)(gp, prior=et.ModelPrior(m), seed=1)
        bolfi = et.BOLFI(m["log_d"], batch_size=1, initial_evidence=10,
                         update_interval=5, target_model=gp,
                         acquisition_method=acq, seed=1)
        t0 = time.perf_counter()
        bolfi.fit(n_evidence=VAR_ACQ_N_EVIDENCE, bar=False)
        fit_s = time.perf_counter() - t0
        lo = np.array([b[0] for b in bounds.values()])
        hi = np.array([b[1] for b in bounds.values()])
        check(gp.n_evidence == VAR_ACQ_N_EVIDENCE
              and bool(np.all(np.isfinite(gp.Y)))
              and bool(np.all((gp.X >= lo) & (gp.X <= hi))),
              f"{cls_name}: bad evidence after the fit")
        check(gp._factor[0].device == torch.device("cuda", 0),
              f"{cls_name}: the GP is on {gp._factor[0].device}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pts = acq.acquire(1, t=VAR_ACQ_N_EVIDENCE - 10)
        torch.cuda.synchronize()
        acq_ms = (time.perf_counter() - t0) * 1e3
        check(bool(np.all(np.isfinite(pts)) and np.all((pts >= lo)
                                                       & (pts <= hi))),
              f"{cls_name}: acquired {pts} outside the bounds")
        log(f"variance acquisition {cls_name}: BOLFI host loop to "
            f"{VAR_ACQ_N_EVIDENCE} in {fit_s!r} s, evidence in the bounds; "
            f"one more acquisition {acq_ms!r} ms wall (synchronised)")
        out[cls_name] = dict(fit_s=fit_s, acquisition_ms=acq_ms)
    return out


def romc_run(m, bounds, seeds, n1, n2, eps=None):
    """One ROMC run as the bench drives it, with no ``device=``: (ROMC, its
    sample, walls of the solve, the regions and the sample), each wall
    ended by a device synchronise.  ``eps`` None takes the bench's
    ``compute_eps(0.5)``."""
    import elfi_tpu_torch as et
    s_romc, s_solve, s_sample = seeds
    romc = et.ROMC(m["d"], bounds=bounds, seed=s_romc)
    t0 = time.perf_counter()
    romc.solve_problems(n1=n1, seed=s_solve)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    romc.estimate_regions(eps_filter=romc.compute_eps(ROMC_QUANTILE)
                          if eps is None else eps)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    res = romc.sample(n2=n2, seed=s_sample)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    return romc, res, dict(solve_s=t1 - t0, regions_s=t2 - t1,
                           sample_s=t3 - t2)


def phase_romc():
    """ROMC at the JAX bench's g-and-k point with no ``device=`` anywhere,
    gated as the bench gates it against the rejection ground truth; the
    walls of the solve, the regions and the sample; one seed triple twice
    equal; launches and device ms per Adam step, per line-search iteration
    and per Hessian, and the busy share; then the JAX accuracy gate's MA2
    point."""
    import elfi_tpu_torch as et
    from elfi_tpu_torch.methods import romc as romc_mod
    from elfi_tpu_torch.models import gnk, ma2
    from elfi_tpu_torch.ops.kernels.gnk import gnk_distance
    from elfi_tpu_torch.ops.kernels.ma2 import ma2_distance
    et.reset_client()
    k_before = (ran(ma2_distance), ran(gnk_distance))
    gt_means = gnk_ground_truth()
    m = gnk.get_model(n_obs=GNK_N_OBS, seed_obs=GNK_SEED_OBS)
    bounds = [(0.0, 10.0)] * 4

    def weighted_means(res):
        w = res.weights / res.weights.sum()
        return np.array([float(np.sum(res.samples[k] * w))
                         for k in GNK_NAMES])

    sections, t_sec = {}, [time.perf_counter()]

    def section(name):
        t = time.perf_counter()
        sections[name] = t - t_sec[0]
        t_sec[0] = t

    warm = romc_run(m, bounds, ROMC_WARMUP_SEEDS, ROMC_N1, ROMC_N2)[2]
    romc, res, walls = romc_run(m, bounds, ROMC_SEEDS, ROMC_N1, ROMC_N2)
    section("warm-up and timed run")
    check(romc.device == torch.device("cuda", 0)
          and romc._objective.device == romc.device,
          f"ROMC without device= ran on {romc.device}")
    means = weighted_means(res)
    share = np.abs(means - gt_means) / ROMC_GATE
    n_solved = int(sum(romc.inference_state["solved"]))
    n_accepted = int(sum(romc.inference_state["accepted"]))
    n_regions = len(romc.posterior.regions)
    eps = romc.inference_args["eps_filter"]
    log(f"gnk romc, seeds {ROMC_SEEDS}: weighted means {means.tolist()!r}, "
        f"ground truth {gt_means.tolist()!r}, |err| / tolerance "
        f"{share.tolist()!r} ({'passes' if np.all(share < 1) else 'fails'} "
        f"the bench's gate alone); solved {n_solved}, accepted "
        f"{n_accepted} at eps {eps!r}, regions {n_regions}, ESS "
        f"{romc.compute_ess()!r}; walls: solve {walls['solve_s']!r} s, "
        f"regions {walls['regions_s']!r} s, sample {walls['sample_s']!r} s "
        f"(warm-up seeds {ROMC_WARMUP_SEEDS}: {warm!r})")
    check(bool(np.all(np.isfinite(means))), f"ROMC: means {means}")

    # the gate, on the mean over the sweep's triples (the first is the
    # timed run), and the parity with the JAX package's sweep
    sweep = [means]
    for k in range(1, ROMC_SWEEP_TRIPLES):
        seeds = tuple(s + 3 * k for s in ROMC_SEEDS)
        sweep.append(weighted_means(romc_run(m, bounds, seeds, ROMC_N1,
                                             ROMC_N2)[1]))
    sweep = np.array(sweep)
    sweep_mean = sweep.mean(0)
    passed = int(np.sum(np.all(np.abs(sweep - gt_means) < ROMC_GATE,
                               axis=1)))
    gap = np.abs(sweep_mean - gt_means)
    parity = np.abs(sweep_mean - ROMC_JAX_SWEEP_MEANS)
    log(f"gnk romc, {ROMC_SWEEP_TRIPLES} triples: mean {sweep_mean.tolist()!r}"
        f", sd {sweep.std(0, ddof=1).tolist()!r}; {passed} triples pass the "
        f"bench's gate alone; |mean - ground truth| {gap.tolist()!r} (< "
        f"{ROMC_GATE.tolist()}); |mean - JAX package's mean| "
        f"{parity.tolist()!r} (< {ROMC_PARITY.tolist()})")
    check(bool(np.all(np.isfinite(sweep))) and bool(np.all(gap < ROMC_GATE)),
          f"ROMC gate failed: mean over triples {sweep_mean}, ground truth "
          f"{gt_means}")
    check(bool(np.all(parity < ROMC_PARITY)),
          f"ROMC: mean over triples {sweep_mean}, the JAX package's "
          f"{ROMC_JAX_SWEEP_MEANS}")
    section("sweep")

    # the same triple again: equal to the timed run
    again = romc_run(m, bounds, ROMC_SEEDS, ROMC_N1, ROMC_N2)[1]
    check(np.array_equal(again.samples_array, res.samples_array)
          and np.array_equal(again.weights, res.weights),
          f"ROMC: two runs with seeds {ROMC_SEEDS} differ")
    log(f"gnk romc, seeds {ROMC_SEEDS} again: equal")
    section("repeat")

    # the parts on the timed run's problems: an Adam step of all n1 x 5
    # restarts (two descents, differenced), a line-search iteration of the
    # region build (its launches over its objective evaluations) and the
    # Hessians of all n1 optima
    obj = romc._objective
    x0 = np.stack([p.initial_point for p in romc.optim_problems])
    starts = torch.as_tensor(np.repeat(x0[:, None], 5, axis=1),
                             device=romc.device)
    lo, hi = romc_mod._bounds_arrays(bounds, 4, romc.device)

    def all_restarts(x):
        return torch.stack([obj(x[:, s]) for s in range(x.shape[1])], dim=1)

    def descent(n):
        with romc_mod.full_float32_matmul():
            return romc_mod.adam_minimize(all_restarts, starts, n, 0.1, lo,
                                          hi)

    _, p1 = profiled(lambda: descent(ROMC_PROFILE_STEPS))
    _, p2 = profiled(lambda: descent(2 * ROMC_PROFILE_STEPS))
    c1, k1, us1, _ = profile_counts(p1)
    c2, k2, us2, events = profile_counts(p2)
    (OUT_DIR / "profile_romc_adam.txt").write_text(events.table(
        sort_by="self_device_time_total", row_limit=40))
    steps = ROMC_PROFILE_STEPS
    adam = dict(launch_calls=(c2 - c1) / steps, kernels=(k2 - k1) / steps,
                device_ms=(us2 - us1) / 1e3 / steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    descent(steps)
    torch.cuda.synchronize()
    adam["wall_ms"] = (time.perf_counter() - t0) * 1e3 / steps

    evaluations = []
    orig_at = obj.at

    def counted_at(rows, theta):
        evaluations.append(theta.shape[1])
        return orig_at(rows, theta)

    accepted = romc.inference_state["accepted"]
    obj.at = counted_at
    try:
        _, prof = profiled(lambda: romc._build_regions_batched(
            accepted, eps_region=eps, use_surrogate=False))
    finally:
        del obj.at
    c, k, us, events = profile_counts(prof)
    (OUT_DIR / "profile_romc_regions.txt").write_text(events.table(
        sort_by="self_device_time_total", row_limit=40))
    n_it = len(evaluations)
    search = dict(iterations=n_it, program_calls_per_iteration=evaluations[0],
                  launch_calls=c / n_it, kernels=k / n_it,
                  device_ms=us / 1e3 / n_it)

    xs = torch.as_tensor(np.stack([p.result.x_min
                                   for p in romc.optim_problems]),
                         dtype=torch.float32, device=romc.device)
    _, prof = profiled(lambda: romc_mod._hessian(obj, xs, "d"))
    c, k, us, events = profile_counts(prof)
    (OUT_DIR / "profile_romc_hessian.txt").write_text(events.table(
        sort_by="self_device_time_total", row_limit=40))
    hessian = dict(launch_calls=c, kernels=k, device_ms=us / 1e3)
    for name, part in (("Adam step (50 x 5 descents)", adam),
                       ("line-search iteration", search),
                       ("Hessian (all 50 optima)", hessian)):
        log(f"gnk romc, {name}: {part!r}")
    # the timed run's device time from its parts: 300 Adam steps, the
    # Hessians and the line-search iterations (the sample's 20 program
    # calls are left out); a profile of the whole run agreed to 0.3 %
    run_ms = (300 * adam["device_ms"] + hessian["device_ms"]
              + n_it * search["device_ms"])
    wall_s = sum(walls.values())
    busy = run_ms / 1e3 / wall_s
    log(f"gnk romc: {run_ms!r} device ms from the parts, busy {busy!r} of "
        f"the timed run's {wall_s!r} s")
    section("parts")

    # the JAX accuracy gate's MA2 point
    mp = ROMC_MA2
    t0 = time.perf_counter()
    _, res_ma2, _ = romc_run(ma2.get_model(seed_obs=SEED_OBS),
                             [(-2, 2), (-1, 1)], mp["seeds"], mp["n1"],
                             mp["n2"], eps=mp["eps"])
    ma2_s = time.perf_counter() - t0
    w = res_ma2.weights / res_ma2.weights.sum()
    ma2_means = np.array([float(np.sum(res_ma2.samples[k] * w))
                          for k in ("t1", "t2")])
    log(f"ma2 romc, the JAX gate's point: means {ma2_means.tolist()!r} in "
        f"{ma2_s!r} s (gate {mp['gate']} from {TRUE_PARAMS.tolist()})")
    check(bool(np.all(np.abs(ma2_means - TRUE_PARAMS) < mp["gate"])),
          f"ROMC MA2 gate failed: means {ma2_means}")
    section("ma2 point")
    log(f"gnk romc, seconds by section: {sections!r}")

    k_after = (ran(ma2_distance), ran(gnk_distance))
    check(k_after == k_before, f"ROMC launched a distance kernel: K1, K2 "
          f"counts {k_before} before the phase, {k_after} after")
    log(f"gnk romc: K1, K2 launch counts {k_after} before and after the "
        "phase (neither launched)")
    return dict(**walls, means=means.tolist(), gt_means=gt_means.tolist(),
                sweep=sweep.tolist(), sweep_mean=sweep_mean.tolist(),
                sweep_passed=passed,
                solved=n_solved, accepted=n_accepted, regions=n_regions,
                eps=eps, warmup=warm, adam_step=adam, line_search=search,
                hessian=hessian, busy_share=busy, run_device_ms=run_ms,
                ma2_means=ma2_means.tolist(), ma2_s=ma2_s,
                sections=sections, device=str(romc.device))


def zoo_batch_profile(fn, steps_of=None):
    """(device ms, kernels, host launch calls) of one call of ``fn``, and
    for an event-loop model (``steps_of`` its ``last_run``) the same per
    loop step."""
    _, prof = profiled(fn)
    calls, kernels, us, _ = profile_counts(prof)
    out = dict(device_ms=us / 1e3, kernels=kernels, launch_calls=calls)
    if steps_of is not None:
        steps = steps_of["steps"]
        out.update(steps=steps, kernels_per_step=kernels / steps,
                   launch_calls_per_step=calls / steps,
                   device_ms_per_step=us / 1e3 / steps)
    return out


def zoo_gate_summaries(name, m, device):
    """Gate (a): the gate statistics' means over N_SUMMARY simulations at
    the true parameters within ZOO_GATE_SE combined standard errors of the
    JAX package's."""
    from scripts.torch_zoo_reference import (N_SUMMARY, SIMULATOR,
                                             TRUE_PARAMS, gate_stats,
                                             summary_names)
    n = N_SUMMARY[name]
    with_values = {p: np.full(n, v, np.float32)
                   for p, v in zip(m.parameter_names, TRUE_PARAMS[name])}
    out = m.generate(n, outputs=[SIMULATOR[name]] + summary_names(m),
                     with_values=with_values, seed=54321, device=device)
    st = gate_stats(name, m, {k: np.asarray(v, np.float64)
                              for k, v in out.items()}, np)
    mean, se = st.mean(0), st.std(0, ddof=1) / np.sqrt(n)
    jmean, jse = (np.asarray(v) for v in ZOO_JAX_SUMMARIES[name])
    z = np.abs(mean - jmean) / np.sqrt(se ** 2 + jse ** 2)
    check(bool(np.all(np.isfinite(st))), f"{name}: non-finite summaries")
    check(float(z.max()) <= ZOO_GATE_SE,
          f"{name}: gate (a) failed, the worst statistic is "
          f"{float(z.max())!r} combined SEs from the JAX package's (column "
          f"{int(z.argmax())}: {mean[z.argmax()]!r} against "
          f"{jmean[z.argmax()]!r})")
    return float(z.max())


def zoo_check_samples(name, m, res):
    """Gate (c): every sample finite and inside the prior's support."""
    from elfi_tpu_torch import ModelPrior
    x = res.samples_array
    check(bool(np.all(np.isfinite(x))), f"{name}: non-finite samples")
    lp = np.atleast_1d(ModelPrior(m).logpdf(x))
    check(bool(np.all(np.isfinite(lp))),
          f"{name}: {int(np.sum(~np.isfinite(lp)))} samples outside the "
          "prior's support")


def phase_zoo(device):
    """Rejection on every device model of the zoo at its get_model
    defaults, with no ``device=``: gates (a)-(d), and per model the wall,
    simulations per second, a batch's device time and busy share, and for
    the event-loop models the steps and the launches per step."""
    import importlib
    import elfi_tpu_torch as et
    from elfi_tpu_torch.compile.compiler import compile_program
    from elfi_tpu_torch.ops.kernels.gnk import gnk_distance
    from elfi_tpu_torch.ops.kernels.ma2 import ma2_distance
    from scripts.torch_zoo_reference import N_SAMPLES, N_SIM
    et.reset_client()
    k_before = (ran(ma2_distance), ran(gnk_distance))
    results = {}
    t_phase = time.perf_counter()
    for name in ("ar1", "arch", "mg1", "stochastic_volatility", "lorenz",
                 "toad", "lotka_volterra", "daycare", "scratch_assay"):
        t_model = time.perf_counter()
        mod = importlib.import_module(f"elfi_tpu_torch.models.{name}")
        m = mod.get_model()
        batch = ZOO_BATCH[name]
        loop = getattr(mod, "last_run", None)
        host = name == "scratch_assay"
        if host:
            n_sim, n_samples = 2 * batch, 4
        elif loop is not None:
            n_sim, n_samples = batch, 64
        else:
            n_sim, n_samples = N_SIM[name], N_SAMPLES
        r = dict(batch=batch, n_sim=n_sim, n_samples=n_samples)
        if not host:
            r["gate_a_worst_se"] = zoo_gate_summaries(name, m, device)
        rej = et.Rejection(m["d"], batch_size=batch, seed=ZOO_SEED)
        check(rej.device == device, f"{name}: Rejection ran on {rej.device}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = rej.sample(n_samples, n_sim=n_sim, bar=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        zoo_check_samples(name, m, res)
        means = res.sample_means_array
        r.update(wall_s=wall, sims_per_s=n_sim / wall,
                 means=means.tolist())
        if loop is not None:
            r.update(steps=loop["steps"], host_reads=loop["checks"])
        if name in ZOO_JAX_REJECTION:
            ref = ZOO_JAX_REJECTION[name]
            tol = ZOO_GATE_SD * np.hypot(ref["sd_jax"], ref["sd_port"])
            err = np.abs(means - np.asarray(ref["mean"]))
            r.update(gate_b_err=err.tolist(), gate_b_tol=tol.tolist())
            check(bool(np.all(err <= tol)),
                  f"{name}: gate (b) failed, posterior means "
                  f"{means.tolist()!r} against the JAX package's "
                  f"{ref['mean']!r}, |err| {err.tolist()!r} > tol "
                  f"{tol.tolist()!r}")
        if not host:
            prog = compile_program(m, ("d",), device=device)

            def one():
                return prog.run(ZOO_SEED, 7, {}, batch)["d"]
            if loop is not None:
                # the rejection ran one batch: its wall is the batch's.  A
                # batch runs up to 20,000-30,000 steps, too many events
                # for the profiler: profile a short horizon (the same step
                # at the same batch) and scale by the batch's steps
                batch_ms = wall * 1e3
                prof = zoo_batch_profile(zoo_short_run(name, mod, batch,
                                                       device), loop)
                dev = prof["device_ms_per_step"] * r["steps"]
                r.update(step_profile=prof)
            else:
                one()                       # the timed call is the second
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                one()
                torch.cuda.synchronize()
                batch_ms = (time.perf_counter() - t0) * 1e3
                prof = zoo_batch_profile(one)
                dev = prof["device_ms"]
                r.update(batch_kernels=prof["kernels"])
            r.update(batch_wall_ms=batch_ms, batch_device_ms=dev,
                     busy=dev / batch_ms)
        r["seconds"] = time.perf_counter() - t_model
        log(f"zoo {name}: {json.dumps(r)}")
        results[name] = r
    k_after = (ran(ma2_distance), ran(gnk_distance))
    check(k_after == k_before, f"the zoo launched a distance kernel: K1, K2 "
          f"counts {k_before} before the phase, {k_after} after")
    log(f"zoo: gates (a)-(d) passed on {len(results)} models in "
        f"{time.perf_counter() - t_phase!r} s; K1, K2 launch counts "
        f"{k_after} before and after the phase")
    return results


def zoo_short_run(name, mod, batch, device):
    """One batch of an event-loop model at its true parameters on a short
    horizon, ending after its first host read: the step is the full
    model's, at the full batch."""
    g = torch.Generator(device=device)
    if name == "daycare":
        t = [torch.full((batch,), v, device=device) for v in (3.6, 0.6, 0.1)]
        return lambda: mod.daycare(*t, time_end=0.01, batch_size=batch,
                                   generator=g.manual_seed(5))
    t = [torch.full((batch,), v, device=device)
         for v in (1.0, 0.005, 0.6, 50., 100.)]
    return lambda: mod.lotka_volterra(*t, n_obs=50, time_end=0.05,
                                      batch_size=batch,
                                      generator=g.manual_seed(5))


def phase_host(device):
    """The host executor on the card: a scipy prior, a device simulator, a
    host summary after it and a device distance, through ``Rejection`` and
    ``Model.generate``; then BDM, its C++ simulator built by
    ``ensure_executable`` into a temporary directory."""
    import os
    import tempfile
    import warnings
    import scipy.stats as ss
    import elfi_tpu_torch as et
    from elfi_tpu_torch.models import bdm
    et.reset_client()
    m = et.Model(name="host_smoke")
    et.Prior(ss.norm(1.0, 0.5), model=m, name="mu")
    seen = {}

    def sim(mu, batch_size=1, generator=None):
        seen["sim"] = (mu.device, generator.device)
        return mu[:, None] + torch.randn((batch_size, 8), generator=generator,
                                         device=generator.device)

    def host_mean(x):
        seen["S"] = type(x)
        return x.mean(1)

    et.Simulator(sim, m["mu"], observed=np.full(8, 1.2, np.float32),
                 model=m, name="sim")
    et.Summary(host_mean, m["sim"], host=True, model=m, name="S")
    et.Distance("euclidean", m["S"], model=m, name="d")
    rej = et.Rejection(m["d"], batch_size=2**14, seed=3)
    t0 = time.perf_counter()
    res = rej.sample(256, n_sim=2**17, bar=False)
    wall = time.perf_counter() - t0
    mu = float(np.mean(res.samples["mu"]))
    check(seen["sim"] == (device, device) and seen["S"] is np.ndarray,
          f"the host graph's nodes ran as {seen}")
    check(abs(mu - 1.2) < 0.1, f"scipy-prior rejection: mean {mu!r}, "
          "expected 1.2 +- 0.1")
    check(all(v.device == device for v in rej.state["samples"].values()),
          "the host graph's merge did not run on the card")
    gen = m.generate(64, outputs=["mu", "S", "d"], seed=4)
    check(gen["S"].shape == (64,) and np.all(np.isfinite(gen["d"])),
          "Model.generate on the host graph gave bad outputs")
    log(f"host graph: scipy prior -> device simulator -> host summary on "
        f"{device}: rejection of 2**17 sims in {wall!r} s, mean {mu!r}")
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        try:
            os.chdir(tmp)
            t0 = time.perf_counter()
            exe = bdm.ensure_executable(tmp)
            build = time.perf_counter() - t0
            check(exe is not None, "g++ could not build bdm")
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                mb = bdm.get_model()
            t0 = time.perf_counter()
            rb = et.Rejection(mb["d"], batch_size=16, seed=2).sample(
                4, n_sim=32, bar=False)
            bwall = time.perf_counter() - t0
            zoo_check_samples("bdm", mb, rb)
        finally:
            os.chdir(cwd)
    log(f"bdm: built by ensure_executable in {build!r} s, rejection of 32 "
        f"sims in {bwall!r} s, alpha mean "
        f"{float(np.mean(rb.samples['alpha']))!r}")
    return dict(scipy_graph_wall_s=wall, scipy_graph_mean=mu,
                bdm_build_s=build, bdm_wall_s=bwall)


# -- pools, persistence, the aux modules and the distributions -------------

def timed_rejection(make, n_samples=N_SAMPLES, **kw):
    """(method, sample, wall seconds) of ``make().sample(n_samples,
    **kw)``, the card synchronised around it."""
    rej = make()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = rej.sample(n_samples, bar=False, **kw)
    torch.cuda.synchronize()
    return rej, res, time.perf_counter() - t0


def check_equal_samples(a, b, what, names=None):
    """``a`` and ``b`` equal bit for bit in ``names`` (default: all their
    outputs, which must be the same)."""
    if names is None:
        check(set(a.outputs) == set(b.outputs), f"{what}: different outputs")
        names = a.outputs
    for k in names:
        check(np.array_equal(a.outputs[k], b.outputs[k]),
              f"{what}: {k} differs")


class count_prior_draws:
    """Counts calls of the MA2 priors' ``rvs`` inside the block."""

    def __enter__(self):
        from elfi_tpu_torch.models import ma2
        self.n = 0
        self.saved = {c: c.__dict__["rvs"]
                      for c in (ma2.CustomPrior1, ma2.CustomPrior2)}
        for cls, orig in self.saved.items():
            def rvs(*a, _orig=orig.__get__(None, cls), **kw):
                self.n += 1
                return _orig(*a, **kw)
            cls.rvs = staticmethod(rvs)
        return self

    def __exit__(self, *exc):
        for cls, orig in self.saved.items():
            cls.rvs = orig


def phase_pool(device):
    """Output pools on the card, with no ``device=``: (a) the MA2 kernel
    graph pooled at batch 2**21 over 16 batches launches K1 16 times and
    equals a pool-less batch-at-a-time run bit for bit; (b) a second run
    with the pool and seed launches K1 zero times, draws no prior and is
    bit-equal; (c) 24 batches launch K1 8 more times and the pool holds 24;
    (d) ``fused=True`` with a pool raises.  A profiled pooled batch gives
    the copy off the card.  Then an ArrayPool of the plain graph's t1, t2
    and simulations (2**17 x 8): saved, opened and replayed through a model
    with another distance on the same node names, with no simulator call
    and equal to that model's own run; deleted."""
    import os
    import tempfile
    import elfi_tpu_torch as et
    from elfi_tpu_torch.models import ma2, ma2_kernel
    from elfi_tpu_torch.ops.kernels.gnk import gnk_distance
    from elfi_tpu_torch.ops.kernels.ma2 import ma2_distance
    from torch.autograd import DeviceType
    et.reset_client()
    m = ma2_kernel.get_model(seed_obs=SEED_OBS)
    kw = dict(batch_size=KERNEL_BATCH, seed=POOL_SEED)
    n_a = POOL_BATCHES * KERNEL_BATCH
    n_c = (POOL_BATCHES + POOL_EXTRA) * KERNEL_BATCH
    k2_before = ran(gnk_distance)
    # warm-up: the allocator at this batch, two batches at a time
    et.Rejection(m["d"], **kw).sample(N_SAMPLES, n_sim=2 * KERNEL_BATCH,
                                      fused=False, bar=False)
    _, ref, ref_wall = timed_rejection(
        lambda: et.Rejection(m["d"], **kw), n_sim=n_a, fused=False)

    from elfi_tpu_torch.ops.kernels.topn import topn_cull
    pool = et.OutputPool(["t1", "t2", "d"])
    reset_counts(ma2_distance, topn_cull)
    rej_a, a, wall_a = timed_rejection(
        lambda: et.Rejection(m["d"], pool=pool, **kw), n_sim=n_a)
    launches_a = ran(ma2_distance)
    check(launches_a == POOL_BATCHES, f"pooled run: K1 launched "
          f"{launches_a} times, expected {POOL_BATCHES}")
    check(len(pool) == POOL_BATCHES, f"pool holds {len(pool)} batches")
    check(rej_a.device == device, f"pooled run on {rej_a.device}")
    check_equal_samples(a, ref, "(a) pooled vs pool-less")
    timers_a = rej_a.batches.timers.report()

    reset_counts(ma2_distance)
    with count_prior_draws() as draws:
        rej_b, b, wall_b = timed_rejection(
            lambda: et.Rejection(m["d"], pool=pool, **kw), n_sim=n_a)
    launches_b = ran(ma2_distance)
    check(launches_b == 0, f"replay: K1 launched {launches_b} times")
    check(draws.n == 0, f"replay: the priors drew {draws.n} times")
    check(all(v.device == device for v in rej_b.state["samples"].values()),
          "replay: the merge did not run on the card")
    check_equal_samples(b, a, "(b) replay vs pooled")
    timers_b = rej_b.batches.timers.report()
    h2d = []
    for i in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rej_b.batches._replayed(i)
        torch.cuda.synchronize()
        h2d.append(time.perf_counter() - t0)

    reset_counts(ma2_distance)
    rej_c, c, wall_c = timed_rejection(
        lambda: et.Rejection(m["d"], pool=pool, **kw), n_sim=n_c)
    launches_c = ran(ma2_distance)
    # a pool runs batch at a time, whose merge is the flat one (as in the
    # JAX package)
    pool_cull = ran(topn_cull)
    check(launches_c == POOL_EXTRA, f"extension: K1 launched {launches_c} "
          f"times, expected {POOL_EXTRA}")
    check(len(pool) == POOL_BATCHES + POOL_EXTRA,
          f"extended pool holds {len(pool)} batches")
    check(c.n_sim == n_c, f"extension: n_sim {c.n_sim}")
    try:
        et.Rejection(m["d"], pool=pool, **kw).sample(
            N_SAMPLES, n_sim=n_a, fused=True, bar=False)
    except ValueError as e:
        check("pool" in str(e), f"(d) raised {e!r}")
    else:
        raise AssertionError("(d) fused=True with a pool did not raise")
    check(ran(gnk_distance) == k2_before, "K2 launched in the pool phase")

    # one pooled batch under the profiler: the copy off the card
    ppool = et.OutputPool(["t1", "t2", "d"])
    rej_p = et.Rejection(m["d"], batch_size=KERNEL_BATCH,
                         seed=POOL_SEED + 1, pool=ppool)
    _, prof = profiled(lambda: rej_p.sample(N_SAMPLES, n_sim=KERNEL_BATCH,
                                            bar=False))
    events, device_us = device_table(prof)
    (OUT_DIR / "profile_ma2_pooled_batch.txt").write_text(events.table(
        sort_by="self_device_time_total", row_limit=30))
    d2h_us = sum(e.self_device_time_total for e in events
                 if e.device_type == DeviceType.CUDA and "DtoH" in e.key)
    k1 = [e for e in events if e.device_type == DeviceType.CUDA
          and "ma2_distance_kernel" in e.key]
    k1_us = sum(e.self_device_time_total for e in k1)
    check(sum(e.count for e in k1) == 1 and k1_us > 0,
          f"the pooled batch's profile holds {sum(e.count for e in k1)} K1 "
          f"kernels ({k1_us} us), expected one")
    check(d2h_us > 0, "the pooled batch's profile holds no copy off the card")
    pooled_bytes = 3 * 4 * KERNEL_BATCH
    log(f"pool (MA2 kernel graph, batch {KERNEL_BATCH}, seed {POOL_SEED}): "
        f"pool-less batch at a time {n_a} sims in {ref_wall!r} s "
        f"({n_a / ref_wall!r} sims/s); (a) pooled {wall_a!r} s "
        f"({n_a / wall_a!r} sims/s), K1 {launches_a}, callback (copy off "
        f"the card) {timers_a['callback']['mean_s'] * 1e3!r} ms a batch for "
        f"{pooled_bytes} bytes; (b) replay {wall_b!r} s ({n_a / wall_b!r} "
        f"sims/s), K1 {launches_b}, prior draws {draws.n}, host-to-device "
        f"of a stored batch {statistics.median(h2d) * 1e3!r} ms; (c) "
        f"extension to {n_c} in {wall_c!r} s, K1 {launches_c}, pool "
        f"{len(pool)}; (d) fused=True raises")
    log(f"pooled batch profiled: device {device_us / 1e3!r} ms, of it "
        f"DtoH copies {d2h_us / 1e3!r} ms and K1 {k1_us / 1e3!r} ms")

    mp = ma2.get_model(seed_obs=SEED_OBS)
    n8 = ARRAY_POOL_BATCHES * PLAIN_BATCH
    with tempfile.TemporaryDirectory() as tmp:
        apool = et.ArrayPool(["t1", "t2", "MA2"], name="ma2_arraypool",
                             prefix=tmp)
        _, _, wall_ap = timed_rejection(
            lambda: et.Rejection(mp["d"], batch_size=PLAIN_BATCH, seed=13,
                                 pool=apool), n_sim=n8)
        t0 = time.perf_counter()
        apool.save()
        save_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(apool.path, f))
                     for f in os.listdir(apool.path))
        opened = et.ArrayPool.open("ma2_arraypool", prefix=tmp)
        check(len(opened) == ARRAY_POOL_BATCHES,
              f"opened ArrayPool holds {len(opened)} batches")
        m2 = ma2.get_model(seed_obs=SEED_OBS)
        et.Distance("cityblock", m2["S1"], m2["S2"], model=m2, name="d_cb")
        sim_calls = {"n": 0}
        sim_op = m2["MA2"].state["op"]

        def counting_sim(*args, **kwargs):
            sim_calls["n"] += 1
            return sim_op(*args, **kwargs)

        m2.update_node("MA2", op=counting_sim)
        _, fresh, _ = timed_rejection(
            lambda: et.Rejection(m2["d_cb"], batch_size=PLAIN_BATCH,
                                 seed=13), n_sim=n8, fused=False)
        check(sim_calls["n"] == ARRAY_POOL_BATCHES,
              f"the new distance's own run simulated {sim_calls['n']} times")
        sim_calls["n"] = 0
        _, replay, wall_replay = timed_rejection(
            lambda: et.Rejection(m2["d_cb"], batch_size=PLAIN_BATCH,
                                 seed=13, pool=opened), n_sim=n8)
        check(sim_calls["n"] == 0,
              f"ArrayPool replay ran the simulator {sim_calls['n']} times")
        # the replay's outputs also hold the pooled simulations
        check_equal_samples(replay, fresh, "ArrayPool replay",
                            names=fresh.outputs)
        path = opened.path
        opened.delete()
        check(not os.path.isdir(path), "ArrayPool.delete left its files")
    log(f"ArrayPool (plain graph, t1, t2, MA2, {ARRAY_POOL_BATCHES} x "
        f"{PLAIN_BATCH}): pooled run {wall_ap!r} s, save {save_s!r} s, "
        f"{nbytes} bytes of .npy; replay through a cityblock distance "
        f"{wall_replay!r} s, 0 simulator calls, equal to its own run; "
        f"deleted")
    return dict(
        launches={"pooled": launches_a, "replay": launches_b,
                  "extension": launches_c},
        merge_launches=pool_cull,
        pooless_wall_s=ref_wall, pooled_wall_s=wall_a, replay_wall_s=wall_b,
        extension_wall_s=wall_c, pooled_sims_per_s=n_a / wall_a,
        replay_sims_per_s=n_a / wall_b,
        callback_ms_per_batch=timers_a["callback"]["mean_s"] * 1e3,
        replay_submit_ms=timers_b["submit"]["mean_s"] * 1e3,
        h2d_ms_per_batch=statistics.median(h2d) * 1e3,
        profiled_batch_device_ms=device_us / 1e3, d2h_device_ms=d2h_us / 1e3,
        k1_device_ms=k1_us / 1e3, array_pool_bytes=nbytes,
        array_pool_wall_s=wall_ap, array_pool_save_s=save_s,
        array_pool_replay_wall_s=wall_replay)


def ss_lag1(y):
    from elfi_tpu_torch.models import ma2
    return ma2.autocov(y)


def ss_lag2(y):
    from elfi_tpu_torch.models import ma2
    return ma2.autocov(y, lag=2)


def phase_persistence_aux(device):
    """Model persistence and the aux modules on the card, with no
    ``device=``: the MA2 kernel model saved after a run on the card (no CUDA
    tensor in the pickle) and loaded gives bit-equal samples at the same
    seed; ``adjust_posterior`` on a plain-graph sample (batch 2**17, 2**21
    simulations) within AUX_GATE of (0.6, 0.2); ``compare_models`` of two
    samples; ``TwoStageSelection`` of the lag-1 and lag-2 autocovariances
    at 2**20 simulations, the simulator run once a batch; a ``Testbench``
    of two repetitions; ``utils.profiling.trace`` around one batch (its
    Chrome trace holds the ``annotate`` name and the card's kernels); and
    matplotlib never imported."""
    import tempfile
    import elfi_tpu_torch as et
    from elfi_tpu_torch.models import ma2, ma2_kernel
    from elfi_tpu_torch.ops.kernels.ma2 import ma2_distance
    from elfi_tpu_torch.utils.profiling import annotate, trace
    et.reset_client()
    out = {}
    mk = ma2_kernel.get_model(seed_obs=SEED_OBS)
    reset_counts(ma2_distance)
    r1 = et.Rejection(mk["d"], batch_size=KERNEL_BATCH, seed=21).sample(
        N_SAMPLES, n_sim=4 * KERNEL_BATCH, bar=False)
    check(device in mk["d"].state["op"]._obs_on,
          "the kernel op kept no copy on the card")
    with tempfile.TemporaryDirectory() as tmp:
        path = mk.save(prefix=tmp)
        with open(path, "rb") as f:
            raw = f.read()
        check(b"cuda" not in raw, "the saved model holds a CUDA tensor")
        loaded = et.load_model(path)
    r2 = et.Rejection(loaded["d"], batch_size=KERNEL_BATCH, seed=21).sample(
        N_SAMPLES, n_sim=4 * KERNEL_BATCH, bar=False)
    check_equal_samples(r2, r1, "loaded model")
    out["persistence_launches"] = ran(ma2_distance)
    check(out["persistence_launches"] == 8,
          f"persistence: K1 launched {ran(ma2_distance)} times")
    log(f"persistence: MA2 kernel model saved from the card ({len(raw)} "
        f"bytes, no CUDA tensor) and loaded: samples equal at seed 21")

    mp = ma2.get_model(seed_obs=SEED_OBS)
    rej = et.Rejection(mp["d"], output_names=["S1", "S2"],
                       batch_size=PLAIN_BATCH, seed=22)
    res = rej.sample(N_SAMPLES, n_sim=16 * PLAIN_BATCH, bar=False)
    t0 = time.perf_counter()
    adj = et.adjust_posterior(res, rej.model, ["S1", "S2"], ["t1", "t2"])
    adj_s = time.perf_counter() - t0
    raw_means = res.sample_means_array
    adj_means = adj.sample_means_array
    check(bool(np.all(np.isfinite(adj.samples_array))),
          "adjusted sample not finite")
    check(bool(np.all(np.abs(adj_means - TRUE_PARAMS) < AUX_GATE)),
          f"adjusted means {adj_means} off (0.6, 0.2) by {AUX_GATE} or more")
    log(f"adjust_posterior: raw means {raw_means.tolist()!r}, adjusted "
        f"{adj_means.tolist()!r} in {adj_s!r} s")
    p = et.compare_models([res, r1])
    check(p.shape == (2,) and bool(np.all(np.isfinite(p)))
          and abs(float(p.sum()) - 1) < 1e-9 and bool(np.all(p >= 0)),
          f"compare_models gave {p}")
    log(f"compare_models(plain graph, kernel graph): {p.tolist()!r}")

    msel = ma2.get_model(seed_obs=SEED_OBS)
    sim_calls = {"n": 0}
    sim_op = msel["MA2"].state["op"]

    def counting_sim(*args, **kwargs):
        sim_calls["n"] += 1
        return sim_op(*args, **kwargs)

    msel.update_node("MA2", op=counting_sim)
    selector = et.TwoStageSelection(msel["MA2"], "euclidean",
                                    list_ss=[ss_lag1, ss_lag2],
                                    max_cardinality=2, seed=23)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    best = selector.run(n_sim=AUX_N_SIM, batch_size=PLAIN_BATCH)
    sel_s = time.perf_counter() - t0
    names = [f.__name__ for f in best]
    check(isinstance(best, tuple) and 1 <= len(best) <= 2,
          f"TwoStageSelection returned {best}")
    check(sim_calls["n"] == AUX_N_SIM // PLAIN_BATCH,
          f"selection simulated {sim_calls['n']} batches, expected "
          f"{AUX_N_SIM // PLAIN_BATCH} (the other candidates replay)")
    log(f"TwoStageSelection (3 candidates, {AUX_N_SIM} sims each, the "
        f"simulator run {sim_calls['n']} times): {names} in {sel_s!r} s")

    tb = et.Testbench(model=mp, repetitions=2, seed=24, progress_bar=False)
    tb.add_method(et.TestbenchMethod(
        et.Rejection, method_kwargs={"batch_size": PLAIN_BATCH,
                                     "discrepancy_name": "d"},
        sample_kwargs={"n_samples": 1000, "n_sim": 8 * PLAIN_BATCH,
                       "bar": False}, name="rejection"))
    t0 = time.perf_counter()
    tb.run()
    tb_s = time.perf_counter() - t0
    diffs = tb.parameterwise_sample_mean_differences()["rejection"]
    check(all(len(v) == 2 and bool(np.all(np.isfinite(v)))
              for v in diffs.values()), f"Testbench differences {diffs}")
    log(f"Testbench (rejection x 2 repetitions) in {tb_s!r} s: "
        f"mean - reference {diffs!r}")

    logdir = OUT_DIR / "trace_one_batch"
    rej = et.Rejection(mp["d"], batch_size=PLAIN_BATCH, seed=25)
    with trace(str(logdir)):
        with annotate("elfi_one_batch"):
            rej.sample(100, n_sim=PLAIN_BATCH, bar=False)
            torch.cuda.synchronize()
    with open(logdir / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    named = sum(1 for e in events if e.get("name") == "elfi_one_batch")
    kernels, launches, lost = trace_completeness(events)
    check(named > 0 and kernels > 0 and launches and not lost,
          f"trace: {named} annotations, {kernels} kernels, the device "
          f"records of {len(lost)} of {len(launches)} host launches lost")
    check("matplotlib" not in sys.modules, "matplotlib was imported")
    log(f"trace: {logdir / 'trace.json'} holds the annotation and "
        f"{kernels} kernels of one batch, a device record for each of its "
        f"{len(launches)} host launches; matplotlib not imported")
    out.update(adjusted_means=adj_means.tolist(), raw_means=raw_means.tolist(),
               compare_models=p.tolist(), selection=names,
               selection_wall_s=sel_s, testbench_wall_s=tb_s,
               trace_kernels=kernels)
    return out


def trace_completeness(events):
    """(the block's kernels, its host launches' correlation ids, those
    without a device record) of a Chrome trace written through
    ``utils.profiling.recorded``: what follows its primer."""
    from elfi_tpu_torch.utils.profiling import PRIMER_NAME
    primer_end = max((e["ts"] + e.get("dur", 0) for e in events
                      if e.get("name") == PRIMER_NAME
                      and e.get("cat") == "user_annotation"), default=0)
    kernels = sum(1 for e in events if e.get("cat") == "kernel"
                  and PRIMER_KERNEL not in e.get("name", ""))
    launches = [e["args"].get("correlation") for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and e.get("name") in LAUNCH_CALLS and e["ts"] > primer_end]
    on_card = {e["args"].get("correlation") for e in events
               if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")}
    return kernels, launches, set(launches) - on_card


def ks_distance(x, dist, discrete):
    """Kolmogorov-Smirnov distance of the sample ``x`` to the frozen scipy
    distribution ``dist``: over every integer of the sample's range for a
    discrete one, at both sides of every sorted point for a continuous
    one."""
    x = np.sort(x)
    n = len(x)
    if discrete:
        k = np.arange(x[0], x[-1] + 1)
        return float(np.max(np.abs(
            np.searchsorted(x, k, side="right") / n - dist.cdf(k))))
    f = dist.cdf(x)
    i = np.arange(1, n + 1)
    return float(max(np.max(i / n - f), np.max(f - (i - 1) / n)))


def gamma_beta_means(res):
    w = np.ones(res.n_samples) if res.weights is None \
        else np.asarray(res.weights, np.float64)
    w = w / w.sum()
    return np.array([np.sum(w * res.samples[k]) for k in "ab"])


def phase_distributions(device):
    """The eleven distributions on the card: 2**22 draws each from a CUDA
    generator, mean and variance within DIST_SE standard errors of scipy's
    (cauchy: median and IQR), a KS distance under DIST_KS; ``logpdf``,
    ``cdf`` and ``ppf`` at DIST_POINTS on the card equal to the CPU.  Then
    the gamma/beta prior model (scripts/torch_prior_reference.py): a device
    graph, its ``ModelPrior`` on the card, rejection at 2**20 a batch and
    SMC, posterior means within GB_TOL of the JAX package's."""
    import scipy.stats as ss
    import elfi_tpu_torch as et
    from elfi_tpu_torch.compile.compiler import compile_program
    from elfi_tpu_torch.ops import distributions as dists
    from elfi_tpu_torch.ops.kernels.gnk import gnk_distance
    from elfi_tpu_torch.ops.kernels.ma2 import ma2_distance
    from scripts.torch_prior_reference import REJ, SMC, port_model
    et.reset_client()
    k_before = (ran(ma2_distance), ran(gnk_distance))
    rng = np.random.default_rng(0)
    out = {}
    for i, (name, params, xr, fns) in enumerate(DIST_CASES):
        dist = getattr(dists, name)
        check(dists.from_name(name) is dist, f"{name} does not resolve")
        sd = getattr(ss, name)(*params)
        g = torch.Generator(device=device).manual_seed(100 + i)
        draw_ms = time_ms(lambda: dist.rvs(*params, size=DIST_DRAWS,
                                           generator=g), warmup=1, reps=5)
        x = dist.rvs(*params, size=DIST_DRAWS, generator=g)
        check(x.device == device and x.shape == (DIST_DRAWS,),
              f"{name}: drew {tuple(x.shape)} on {x.device}")
        x = x.double().cpu().numpy()
        n = len(x)
        if name == "cauchy":
            loc, scale = params
            q = np.percentile(x, [25, 50, 75])
            se = scale * np.pi * np.sqrt(np.array([3, 4, 3]) / 16 / n) \
                * np.array([2.0, 1.0, 2.0])
            stats = dict(median=q[1], iqr=q[2] - q[0])
            errs = np.abs(q - (loc + scale * np.array([-1, 0, 1]))) / se
        else:
            mean, var, kurt = (float(v) for v in sd.stats(moments="mvk"))
            se_mean = np.sqrt(var / n)
            se_var = var * np.sqrt((kurt + 2) / n)
            stats = dict(mean=float(x.mean()), var=float(x.var()))
            errs = np.array([abs(x.mean() - mean) / se_mean,
                             abs(x.var() - var) / se_var])
        check(bool(np.all(errs < DIST_SE)), f"{name}: moments {stats} are "
              f"{errs.tolist()} SEs from scipy's")
        ks = ks_distance(x, sd, name in ("binom", "poisson"))
        check(ks < DIST_KS, f"{name}: KS distance {ks} >= {DIST_KS}")
        worst = {}
        for fn in fns:
            arg = (rng.uniform(0, 1, DIST_POINTS) if fn == "ppf" else
                   np.arange(21.0) if xr is None else
                   rng.uniform(*xr, DIST_POINTS)).astype(np.float32)
            arg = torch.as_tensor(arg)
            on_card = getattr(dist, fn)(arg.to(device), *params)
            check(on_card.device == device, f"{name}.{fn} left the card")
            on_cpu = getattr(dist, fn)(arg, *params).numpy()
            on_card = on_card.cpu().numpy()
            rtol, atol = DIST_TOL_LOOSE if (name, fn) in DIST_LOOSE \
                else DIST_TOL
            check(np.array_equal(np.isfinite(on_card), np.isfinite(on_cpu)),
                  f"{name}.{fn}: non-finite values differ card/CPU")
            fin = np.isfinite(on_cpu)
            excess = np.abs(on_card[fin] - on_cpu[fin]) - (
                atol + rtol * np.abs(on_cpu[fin]))
            check(bool(np.all(excess <= 0)), f"{name}.{fn}: card and CPU "
                  f"differ beyond rtol {rtol}, atol {atol}")
            worst[fn] = float(np.max(np.abs(on_card[fin] - on_cpu[fin])
                                     / np.maximum(np.abs(on_cpu[fin]),
                                                  1e-30)))
        out[name] = dict(draw_ms=draw_ms, ks=ks, se_errs=errs.tolist(),
                         card_cpu_rel=worst, **stats)
        log(f"{name}{params}: 2**22 draws in {draw_ms!r} ms on the card, "
            f"{stats}, {np.round(errs, 3).tolist()} SEs, KS {ks!r}; card vs "
            f"CPU worst rel {worst}")

    et_, m = port_model()
    prog = compile_program(m, ("d", "a", "b"), device=device)
    check(not prog.host, "the gamma/beta graph is a host graph")
    prior = et.ModelPrior(m)
    check(not prior.host and prior.device == device,
          "the gamma/beta ModelPrior is not on the card")
    lp = prior.traceable_logpdf()(torch.tensor([[1.0, 0.3]], device=device))
    want = ss.gamma.logpdf(1.0, 2.0) + ss.beta.logpdf(0.3, 2.0, 5.0)
    check(lp.device == device and abs(float(lp) - want) < 1e-4,
          f"ModelPrior logpdf {float(lp)} on {lp.device}, scipy {want}")
    rej, r, rwall = timed_rejection(
        lambda: et.Rejection(m["d"], batch_size=REJ["batch_size"], seed=1),
        n_samples=REJ["n_samples"], n_sim=REJ["n_sim"])
    check(all(v.device == device for v in rej.state["samples"].values()),
          "gamma/beta rejection did not run on the card")
    smc = et.SMC(m["d"], batch_size=SMC["batch_size"], seed=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = smc.sample(SMC["n_samples"], quantiles=SMC["quantiles"], bar=False)
    torch.cuda.synchronize()
    swall = time.perf_counter() - t0
    check(smc._prior.device == device, "SMC's prior is not on the card")
    for kind, res in (("rejection", r), ("smc", s)):
        means = gamma_beta_means(res)
        err = np.abs(means - GB_JAX_MEANS[kind])
        check(bool(np.all(err < GB_TOL[kind])), f"gamma/beta {kind}: means "
              f"{means} vs the JAX package's {GB_JAX_MEANS[kind]}")
        out[f"gamma_beta_{kind}"] = dict(means=means.tolist(),
                                         err=err.tolist())
        log(f"gamma/beta {kind}: means {means.tolist()!r}, |err| to JAX "
            f"{err.tolist()!r} (tolerance {GB_TOL[kind].tolist()})")
    k_after = (ran(ma2_distance), ran(gnk_distance))
    check(k_after == k_before, "a distance kernel launched in the "
          "distributions phase")
    log(f"gamma/beta on the card: rejection {REJ['n_sim']} sims in "
        f"{rwall!r} s, SMC {s.n_populations} rounds in {swall!r} s")
    out.update(gamma_beta_rejection_wall_s=rwall, gamma_beta_smc_wall_s=swall)
    return out


def phase_default_device():
    """The MA2 kernel graph with no ``device=`` anywhere and no backend set:
    the port's default, the current CUDA device, through K1."""
    import elfi_tpu_torch as et
    from elfi_tpu_torch.models import ma2_kernel
    from elfi_tpu_torch.ops.kernels.ma2 import ma2_distance
    et.reset_client()
    m = ma2_kernel.get_model(seed_obs=SEED_OBS)
    from elfi_tpu_torch.ops.kernels.topn import topn_cull
    rej = et.Rejection(m["d"], batch_size=KERNEL_BATCH, seed=1)
    reset_counts(ma2_distance, topn_cull)
    res = rej.sample(1000, n_sim=8 * KERNEL_BATCH, bar=False)
    torch.cuda.synchronize()
    launches = ran(ma2_distance)
    cull = ran(topn_cull)
    where = {rej.device, *(v.device for v in rej.state["samples"].values())}
    log(f"default device: Rejection without device= ran on "
        f"{sorted(map(str, where))}; ma2_distance launches {launches} "
        f"(expected 8)")
    check(where == {torch.device("cuda", 0)},
          f"the default device run was on {where}, not cuda:0")
    check(launches == 8, f"K1 launched {launches} times, expected 8")
    check(res.samples["t1"].shape == (1000,)
          and bool(np.all(np.isfinite(res.samples_array))),
          "the default device run gave bad samples")
    return dict(launches=launches, merge_launches=cull,
                device=str(rej.device))


# -- the backends beyond one device --------------------------------------------

BACKENDS_SEED = 12
BACKENDS_BATCHES = 16    # MA2 kernel-graph batches over the device list
GNK_LIST_BATCHES = 4
HOST_BATCH = 2**16       # the all-host graph (scripts/torch_host_graph.py)
HOST_BATCHES = 32        # timed through native, the pool and the cluster
KILL_BATCHES = 8         # in flight when a cluster worker is killed
POOL_PROCESSES = 4
POOL_PLAIN_BATCH = 2**14
POOL_PLAIN_BATCHES = 64
CLUSTER_LOCAL_BATCHES = 4
MULTIHOST_BATCHES = 8
NUTS_CHAINS, NUTS_ITERS = 8, 200
BACKENDS_LIMIT_S = 60.0


def _helper_env():
    """The environment of a helper process: the checkout on its path, one
    torch thread."""
    import os
    root = str(Path(__file__).resolve().parent)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    return env, root


def multihost_rank(rank, address, out_dir, device, batch, n_samples):
    """One rank of the backends phase's two-process job: the MA2 kernel
    graph at ``batch`` through ``MultihostBackend`` over gloo on
    ``device``, batch at a time; writes its samples, its K1 launches and
    its wall.  Booted, it writes ``ready<rank>`` and touches the card only
    once the phase writes ``go``, so that no other timed run of the phase
    shares the card or the host with it."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=address, world_size=2,
                            rank=rank)
    import elfi_tpu_torch as et
    from elfi_tpu_torch.models import ma2_kernel
    from elfi_tpu_torch.ops.kernels.ma2 import ma2_distance
    from elfi_tpu_torch.parallel.multihost import MultihostBackend
    out = Path(out_dir)
    (out / f"ready{rank}").touch()
    deadline = time.monotonic() + 300
    while not (out / "go").exists():
        check(time.monotonic() < deadline, f"rank {rank} got no go")
        time.sleep(0.02)
    device, batch, n_samples = torch.device(device), int(batch), \
        int(n_samples)
    backend = et.set_client(MultihostBackend(device=device))
    check(backend.num_processes == 2, "the multihost job has no 2 ranks")
    m = ma2_kernel.get_model(seed_obs=SEED_OBS)
    # a warm-up of one batch a rank (the library, the program, the first
    # broadcast), then both ranks start the timed run together
    et.Rejection(m["d"], batch_size=batch, seed=BACKENDS_SEED + 1).sample(
        n_samples, n_sim=2 * batch, bar=False)
    dist.barrier()
    reset_counts(ma2_distance)
    res, wall = _timed(lambda: et.Rejection(
        m["d"], batch_size=batch, seed=BACKENDS_SEED).sample(
        n_samples, n_sim=MULTIHOST_BATCHES * batch, bar=False))
    np.save(out / f"rank{rank}.npy", res.samples_array)
    (out / f"rank{rank}.json").write_text(json.dumps(dict(
        launches=ran(ma2_distance), wall_s=wall)))
    dist.destroy_process_group()
    return 0


def _start_multihost(out_dir, device):
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env, root = _helper_env()
    return [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--multihost-rank",
         str(r), f"tcp://localhost:{port}", str(out_dir), str(device),
         str(KERNEL_BATCH), str(N_SAMPLES)], cwd=root, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]


def _start_cluster_worker(address, log_path):
    env, root = _helper_env()
    return subprocess.Popen(
        [sys.executable, "-m", "elfi_tpu_torch.worker", address], cwd=root,
        env=env, stdout=subprocess.DEVNULL,
        stderr=open(log_path, "w"))


def _timed(fn):
    """(``fn()``, wall seconds), the card synchronised around it."""
    sync = torch.cuda.synchronize if torch.cuda.is_available() \
        else (lambda: None)
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def pool_probe(program, seed, batch_size, until):
    """Run in a pool worker: the parts of a task's time there.  The
    shipped program compiled for this CPU, its first run (this process's
    first work on that graph), a second run, then a fresh unpickled copy
    compiled and run as every task's is; then it waits until ``until``
    (host clock) so that each worker takes one probe."""
    import os
    import pickle
    t = [time.perf_counter()]
    prog = program.on("cpu")
    t.append(time.perf_counter())
    prog.run(seed, 0, {}, batch_size)
    t.append(time.perf_counter())
    prog.run(seed, 1, {}, batch_size)
    t.append(time.perf_counter())
    copy = pickle.loads(pickle.dumps(program)).on("cpu")
    t.append(time.perf_counter())
    copy.run(seed, 2, {}, batch_size)
    t.append(time.perf_counter())
    time.sleep(max(0.0, until - time.time()))
    parts = np.diff(t).tolist()
    return dict(pid=os.getpid(), **dict(zip(
        ("compile_s", "first_run_s", "run_s", "copy_compile_s",
         "copy_run_s"), parts)))


def phase_backends(device):
    """The backends beyond one device, on the card (gates (a)-(d)):

    (a) the device list ``ShardedBackend(["cuda:0", "cuda:0"])``: fused
        rejection and SMC on the MA2 kernel graph and a g-and-k kernel-graph
        rejection equal to native bit for bit, each kernel launched once a
        batch; ``nuts_chains``, BSL and ROMC at the JAX tests' MA2 points
        over the list equal to the one-device runs;
    (b) ``MultiprocessingBackend(4)``: the all-host graph equal to native on
        the card, the MA2 plain graph equal to native on the CPU, both
        timed after each worker ran one task of each graph;
    (c) ``ClusterBackend`` on the card: with no worker the MA2 kernel graph
        runs locally through K1; with two ``python -m
        elfi_tpu_torch.worker`` processes the all-host graph equals native,
        and still does when one of them is killed mid-run;
    (d) ``MultihostBackend``: two processes on cuda:0 over gloo give the
        one-process samples and each launches K1 for its own batches.

    The helper processes start once (a)'s timed runs are done and boot
    while its untimed checks run; every timed run of (b), (c) and (d)
    starts with the other helpers idle (the ranks wait for a ``go`` file
    until (d))."""
    import tempfile
    import elfi_tpu_torch as et
    from elfi_tpu_torch.compile.compiler import compile_program
    from elfi_tpu_torch.methods.mcmc import nuts_chains
    from elfi_tpu_torch.models import gnk_kernel, ma2, ma2_kernel
    from elfi_tpu_torch.ops.kernels.gnk import gnk_distance
    from elfi_tpu_torch.ops.kernels.ma2 import ma2_distance
    from elfi_tpu_torch.ops.kernels.topn import topn_cull
    from elfi_tpu_torch.parallel.cluster import ClusterBackend
    from scripts.torch_host_graph import get_model as host_model
    t_phase = time.perf_counter()
    out, launches, cull = {}, {}, {}
    tmp = tempfile.TemporaryDirectory()
    helpers = []
    mk = ma2_kernel.get_model(seed_obs=SEED_OBS)

    def kernel_rejection(client, n_batches=CLUSTER_LOCAL_BATCHES):
        et.set_client(client)
        return et.Rejection(mk["d"], batch_size=KERNEL_BATCH,
                            seed=BACKENDS_SEED).sample(
            N_SAMPLES, n_sim=n_batches * KERNEL_BATCH, bar=False)

    cluster = pool = None
    try:
        # (c) first, before any worker exists: the master computes locally
        cluster = ClusterBackend(device=device)
        reset_counts(ma2_distance)
        local, wall = _timed(lambda: kernel_rejection(cluster))
        launches["cluster local"] = ran(ma2_distance)
        check(launches["cluster local"] == CLUSTER_LOCAL_BATCHES,
              f"the cluster master launched K1 {launches['cluster local']} "
              f"times, expected {CLUSTER_LOCAL_BATCHES}")
        native_k = kernel_rejection(et.NativeBackend(device))
        check_equal_samples(local, native_k, "cluster master, no worker")
        log(f"backends (c): no worker attached, the cluster master ran "
            f"{CLUSTER_LOCAL_BATCHES} MA2 kernel batches of 2**21 on the "
            f"card in {wall!r} s, K1 {launches['cluster local']} times, "
            "equal to native")
        out["cluster_local_wall_s"] = wall
        # (a) the device list
        one = et.ShardedBackend([device])
        two = et.ShardedBackend([device, device])
        check(two.mesh == [device, device] and two.num_cores == 4,
              f"the device list is {two.mesh}")
        # timed in turns (native, one, two, two, one, native): a pair in
        # one process, not two runs apart
        clients = {"native": et.NativeBackend(device), "one": one,
                   "two": two}
        runs, walls = {}, {name: [] for name in clients}
        for name in ("native", "one", "two", "two", "one", "native"):
            reset_counts(ma2_distance, topn_cull)
            runs[name], wall = _timed(lambda c=clients[name]:
                                      kernel_rejection(c, BACKENDS_BATCHES))
            check(ran(ma2_distance) == BACKENDS_BATCHES,
                  f"rejection on {name}: K1 launched "
                  f"{ran(ma2_distance)} times, expected "
                  f"{BACKENDS_BATCHES}")
            walls[name].append(wall)
            if name == "two":
                launches["list rejection"] = ran(ma2_distance)
                cull["list rejection"] = ran(topn_cull)
        out["list_rejection_wall_s"] = walls
        for name in ("one", "two"):
            check_equal_samples(runs[name], runs["native"],
                                f"fused rejection over the list ({name})")
        log(f"backends (a): fused MA2 kernel rejection, {BACKENDS_BATCHES} "
            f"batches of 2**21, walls in s: {walls}; equal bit for bit, K1 "
            "once a batch")
        smc, smc_walls = {}, {"native": [], "two": []}
        for name in ("native", "two", "two", "native"):
            et.set_client(clients[name])
            reset_counts(ma2_distance, topn_cull)
            sampler = et.SMC(mk["d"], batch_size=SMC_BATCH, seed=3)
            smc[name], wall = _timed(lambda: sampler.sample(
                500, quantiles=[0.25, 0.25, 0.25], bar=False))
            # natively, a captured proposal chunk that needed a redraw
            # round runs again eagerly (16 batches: K1 twice)
            redone = sampler.state.get("redone_chunks", 0)
            check(ran(ma2_distance) == smc[name].n_batches + 16 * redone,
                  f"SMC on {name}: K1 {ran(ma2_distance)} times for "
                  f"{smc[name].n_batches} batches, {redone} chunks again")
            smc_walls[name].append(wall)
            if name == "two":
                launches["list smc"] = ran(ma2_distance)
                cull["list smc"] = ran(topn_cull)
        out["list_smc_wall_s"] = smc_walls
        check(np.array_equal(smc["two"].samples_array,
                             smc["native"].samples_array),
              "SMC over the list differs from native")
        check_ma2_gate("ma2 smc kernel graph over the list", smc["two"])
        mg = gnk_kernel.get_model(n_obs=GNK_N_OBS, seed_obs=GNK_SEED_OBS)
        gnk_runs = {}
        for name in ("native", "two"):
            et.set_client(clients[name])
            reset_counts(gnk_distance, topn_cull)
            gnk_runs[name], wall = _timed(lambda: et.Rejection(
                mg["d"], batch_size=GNK_BATCH, seed=BACKENDS_SEED).sample(
                1000, n_sim=GNK_LIST_BATCHES * GNK_BATCH, bar=False))
            check(ran(gnk_distance) == GNK_LIST_BATCHES,
                  f"g-and-k on {name}: K2 {ran(gnk_distance)} times")
            out[f"list_gnk_{name}_wall_s"] = wall
        launches["list gnk"] = ran(gnk_distance)
        cull["list gnk"] = ran(topn_cull)
        check_equal_samples(gnk_runs["two"], gnk_runs["native"],
                            "g-and-k rejection over the list")

        # the helpers boot while (a)'s untimed checks run; nothing above
        # ran beside them
        workers = [_start_cluster_worker(
            cluster.address, Path(tmp.name) / f"worker{i}.log")
            for i in range(2)]
        helpers += workers
        ranks = _start_multihost(tmp.name, device)
        helpers += ranks
        pool = et.MultiprocessingBackend(POOL_PROCESSES, device=device)
        # thunks run at get_result, so the warm-up and the probes go to
        # the executor itself, all in flight at once
        boot = [pool._pool.submit(time.sleep, 0)
                for _ in range(POOL_PROCESSES)]

        def std_normal(x):
            return -0.5 * torch.sum(x * x, dim=-1)

        # NUTS, BSL and ROMC run on the list's first device: the
        # one-device runs, bit for bit
        x0s = np.linspace(-1, 1, NUTS_CHAINS)[:, None] * np.ones((1, 2))
        et.set_client("native", device=device)
        chains = {name: nuts_chains(NUTS_ITERS, x0s, std_normal, seed=3,
                                    mesh=mesh, device=device)
                  for name, mesh in (("single", None), ("two", two.mesh))}
        check(np.array_equal(chains["two"], chains["single"]),
              "NUTS over the list differs from one device")
        flat = chains["single"][:, NUTS_ITERS // 2:].reshape(-1, 2)
        check(bool(np.all(np.abs(flat.mean(0)) < 0.15)
                   and np.all(np.abs(flat.std(0) - 1) < 0.2)),
              f"NUTS: mean {flat.mean(0)}, sd {flat.std(0)}")
        m4 = ma2.get_model(seed_obs=4)
        bsl, romc = {}, {}
        for name, client in (("native", et.NativeBackend(device)),
                             ("two", two)):
            et.set_client(client)
            bsl[name] = et.BSL(
                m4, n_sim_round=300, feature_names=["S1", "S2"],
                seed=4).sample(120, sigma_proposals=np.diag([.05, .05]),
                               params0=np.array([[.6, .2]]), burn_in=20,
                               fused=True, bar=False)
            r = et.ROMC(m4["d"], bounds=[(-2, 2), (-1, 1)], seed=1)
            r.solve_problems(n1=20, seed=2)
            eps = r.compute_eps(quantile=0.9)
            check(eps < 0.1, f"ROMC {name}: eps {eps}")
            r.estimate_regions(eps_filter=0.05)
            romc[name] = r.sample(n2=20, seed=3)
        check(np.array_equal(bsl["two"].samples_array,
                             bsl["native"].samples_array),
              "BSL over the list differs from native")
        check(np.array_equal(romc["two"].samples_array,
                             romc["native"].samples_array)
              and np.array_equal(romc["two"].weights,
                                 romc["native"].weights),
              "ROMC over the list differs from native")
        log(f"backends (a): SMC {smc['two'].n_batches} batches equal (walls "
            f"in s {smc_walls}), g-and-k {GNK_LIST_BATCHES} batches equal; "
            "NUTS, BSL and ROMC over the list equal to one device")

        # every helper booted and idle before anything is timed
        for f in boot:
            f.result(timeout=120)
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and (
                len(cluster._workers) < 2
                or not all((Path(tmp.name) / f"ready{r}").exists()
                           for r in range(2))):
            cluster._absorb_joined()
            time.sleep(0.05)
        check(len(cluster._workers) == 2, "the cluster workers never "
              "attached")
        check(all((Path(tmp.name) / f"ready{r}").exists()
                  for r in range(2)), "the multihost ranks never booted")

        # (b) the process pool: each worker first runs one probe of each
        # graph (its first task on it), then the timed runs
        mh = host_model()
        mp_ = ma2.get_model(seed_obs=SEED_OBS)
        probes = {}
        for name, m_, bs in (("host", mh, HOST_BATCH),
                             ("ma2_plain", mp_, POOL_PLAIN_BATCH)):
            prog = compile_program(m_, ("d",), device=device)
            until = time.time() + 3.0
            futures = [pool._pool.submit(pool_probe, prog, BACKENDS_SEED,
                                         bs, until)
                       for _ in range(POOL_PROCESSES)]
            probes[name] = [f.result(timeout=120) for f in futures]
            check(len({p["pid"] for p in probes[name]}) == POOL_PROCESSES,
                  f"the {name} probes ran on "
                  f"{len({p['pid'] for p in probes[name]})} workers")
            parts = {k: [p[k] for p in probes[name]]
                     for k in probes[name][0] if k != "pid"}
            out[f"pool_{name}_task_parts_s"] = parts
            log(f"backends (b): a pool worker's {name} task parts in s: "
                f"{parts}")
        host = {}
        kw = dict(n_sim=HOST_BATCHES * HOST_BATCH)
        for name, client in (("native", et.NativeBackend(device)),
                             ("pool", pool)):
            et.set_client(client)
            host[name], wall = _timed(lambda: et.Rejection(
                mh["d"], batch_size=HOST_BATCH, seed=BACKENDS_SEED).sample(
                1000, bar=False, **kw))
            out[f"host_{name}_sims_per_s"] = kw["n_sim"] / wall
        check_equal_samples(host["pool"], host["native"],
                            "all-host graph through the pool")
        plain = {}
        kw = dict(n_sim=POOL_PLAIN_BATCHES * POOL_PLAIN_BATCH)
        for name, client in (("native cpu", et.NativeBackend("cpu")),
                             ("pool", pool)):
            et.set_client(client)
            plain[name], wall = _timed(lambda: et.Rejection(
                mp_["d"], batch_size=POOL_PLAIN_BATCH,
                seed=BACKENDS_SEED).sample(500, bar=False, **kw))
            out[f"ma2_plain_{name.replace(' ', '_')}_sims_per_s"] = \
                kw["n_sim"] / wall
        check_equal_samples(plain["pool"], plain["native cpu"],
                            "MA2 plain graph through the pool")
        log(f"backends (b): pool of {POOL_PROCESSES}, warm: all-host graph "
            f"{HOST_BATCHES} x 2**16 {out['host_pool_sims_per_s']!r} sims/s "
            f"against native {out['host_native_sims_per_s']!r}, equal; MA2 "
            f"plain graph {POOL_PLAIN_BATCHES} x 2**14 "
            f"{out['ma2_plain_pool_sims_per_s']!r} sims/s against native "
            f"on the CPU {out['ma2_plain_native_cpu_sims_per_s']!r}, equal")
        pool.close()
        pool = None

        # (c) the cluster with two workers, each warmed by a batch
        et.set_client(cluster)
        et.Rejection(mh["d"], batch_size=HOST_BATCH, seed=1).sample(
            100, n_sim=2 * HOST_BATCH, bar=False)
        farmed, wall = _timed(lambda: et.Rejection(
            mh["d"], batch_size=HOST_BATCH, seed=BACKENDS_SEED).sample(
            1000, n_sim=HOST_BATCHES * HOST_BATCH, bar=False))
        out["host_cluster_sims_per_s"] = HOST_BATCHES * HOST_BATCH / wall
        check_equal_samples(farmed, host["native"],
                            "all-host graph through the cluster")
        rej = et.Rejection(mh["d"], batch_size=HOST_BATCH, seed=7)
        rej.set_objective(100, n_sim=KILL_BATCHES * HOST_BATCH)
        for i in range(KILL_BATCHES):
            rej.batches.submit(rej.prepare_new_batch(i))
        assigned = {id(w): [cluster._tasks[t].batch_index
                            for t in w.inflight] for w in cluster._workers}
        workers[0].kill()          # one worker dies with a batch in flight
        workers[0].wait()
        t_kill = time.perf_counter()
        got, done_at = {}, {}
        for _ in range(KILL_BATCHES):
            batch, idx = rej.batches.wait_next()
            got[idx] = batch
            done_at[idx] = time.perf_counter() - t_kill
        check(len(cluster._workers) == 1, "the killed worker was not "
              "dropped")
        lost = [i for w, idx in assigned.items()
                if w != id(cluster._workers[0]) for i in idx]
        check(len(lost) > 0, "the killed worker held no batch")
        reassigned_s = max(done_at[i] for i in lost)
        et.set_client("native", device=device)
        ref = et.Rejection(mh["d"], batch_size=HOST_BATCH, seed=7)
        ref.set_objective(100, n_sim=KILL_BATCHES * HOST_BATCH)
        for i in range(KILL_BATCHES):
            want = ref.batches.compute(i, ref.prepare_new_batch(i))
            for k, v in want.items():
                check(torch.equal(got[i][k].to(v.device), v),
                      f"cluster batch {i} {k} differs after the kill")
        out["cluster_reassigned_s"] = reassigned_s
        log(f"backends (c): two workers, warm: all-host graph "
            f"{out['host_cluster_sims_per_s']!r} sims/s, equal to native; "
            f"a worker killed mid-run, its batch back {reassigned_s!r} s "
            f"later, all {KILL_BATCHES} batches equal to native")
        cluster.close()
        cluster = None

        # (d) the two-process job, alone on the card
        (Path(tmp.name) / "go").touch()
        logs = [p.communicate(timeout=180)[0] for p in ranks]
        for r, (p, text) in enumerate(zip(ranks, logs)):
            check(p.returncode == 0, f"multihost rank {r} failed:\n"
                  f"{text[-3000:]}")
        et.set_client("native", device=device)
        want = kernel_rejection(et.NativeBackend(device), MULTIHOST_BATCHES)
        for r in range(2):
            got_r = np.load(Path(tmp.name) / f"rank{r}.npy")
            info = json.loads((Path(tmp.name) / f"rank{r}.json").read_text())
            check(np.array_equal(got_r, want.samples_array),
                  f"multihost rank {r} differs from the native run")
            check(info["launches"] == MULTIHOST_BATCHES // 2,
                  f"rank {r} launched K1 {info['launches']} times, expected "
                  f"{MULTIHOST_BATCHES // 2}")
            launches[f"multihost rank {r}"] = info["launches"]
            out[f"multihost_rank{r}_sims_per_s"] = \
                MULTIHOST_BATCHES * KERNEL_BATCH / info["wall_s"]
        log(f"backends (d): two ranks on cuda:0 over gloo, "
            f"{MULTIHOST_BATCHES} batches of 2**21: both equal to the "
            f"one-process run, K1 {MULTIHOST_BATCHES // 2} times each; "
            f"{out['multihost_rank0_sims_per_s']!r} sims/s on rank 0")
    finally:
        et.reset_client()
        if cluster is not None:
            cluster.close()
        if pool is not None:
            pool.close()
        for p in helpers:
            if p.poll() is None:
                try:
                    p.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
        tmp.cleanup()
    wall = time.perf_counter() - t_phase
    log(f"backends phase: {wall!r} s (limit {BACKENDS_LIMIT_S}) on "
        f"{card_line()}")
    check(wall < BACKENDS_LIMIT_S, f"the backends phase took {wall} s")
    out["wall_s"] = wall
    out["launches"] = launches
    out["merge_launches"] = cull
    return out


def card_events(events):
    """The kernels, copies and memsets among a profile's averaged events:
    not the spans the profiler draws on the card for a host annotation
    (such as a ``ProfilerStep``), which would count their kernels again,
    nor ``recorded``'s primer kernels."""
    from torch.autograd import DeviceType
    return [e for e in events
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation
            and PRIMER_KERNEL not in e.key]


def device_table(prof):
    """(events, device microseconds) of a profile: kernels, copies and
    memsets only, since an operator's own device time repeats its
    kernels'."""
    events = prof.key_averages()
    return events, sum(e.self_device_time_total for e in card_events(events))


def log_top(events, device_us, nb):
    top = sorted(card_events(events),
                 key=lambda e: -e.self_device_time_total)[:5]
    for e in top:
        log(f"  {e.self_device_time_total / 1e3 / nb:.4f} ms/batch "
            f"({e.self_device_time_total / device_us:.3f}) {e.key[:90]}")


def phase_profile(device, main_path):
    """Profile a few batches of each graph: device time per batch, and the
    main path's device busy share (that time over the main path's wall time
    per batch).  Tables go to build/profiles/."""
    import elfi_tpu_torch as et
    from elfi_tpu_torch.models import gnk, gnk_kernel, ma2, ma2_kernel
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    gnk_kw = dict(n_obs=GNK_N_OBS, seed_obs=GNK_SEED_OBS)
    for name, mod, kw, bs, nb in (
            ("plain graph", ma2, dict(seed_obs=SEED_OBS), PLAIN_BATCH, 64),
            ("kernel graph", ma2_kernel, dict(seed_obs=SEED_OBS),
             KERNEL_BATCH, 8),
            ("gnk plain graph", gnk, gnk_kw, GNK_BATCH, 4),
            ("gnk kernel graph", gnk_kernel, gnk_kw, GNK_BATCH, 8)):
        m = mod.get_model(**kw)
        rej = et.Rejection(m["d"], batch_size=bs, seed=1, device=device)
        rej.sample(N_SAMPLES, n_sim=2 * bs, bar=False)
        _, prof = profiled(lambda: rej.sample(N_SAMPLES, n_sim=nb * bs,
                                              bar=False))
        events, device_us = device_table(prof)
        per_batch_ms = device_us / 1e3 / nb
        run = main_path[name]
        wall_ms = run["seconds"] * 1e3 / run["n_batches"]
        run["device_ms_per_batch"] = per_batch_ms
        run["busy_share"] = per_batch_ms / wall_ms
        fname = "profile_" + "_".join(name.split()[:-1]) + ".txt"
        (OUT_DIR / fname).write_text(events.table(
            sort_by="self_device_time_total", row_limit=30))
        log(f"profile {name}: device {per_batch_ms!r} ms/batch over {nb} "
            f"batches of {bs}; main path {wall_ms!r} ms/batch wall, so the "
            f"device is busy {run['busy_share']!r} of it; table in "
            f"build/profiles/{fname}")
        log_top(events, device_us, nb)

    # the whole gauss2d SMC run of phase 10, seed 4 again: the same batches
    from elfi_tpu_torch.models import gauss
    m = gauss.get_model(**GAUSS_KW)
    res, prof = profiled(lambda: et.SMC(
        m["d"], batch_size=GAUSS_BATCH, seed=4, device=device).sample(
            GAUSS_N, thresholds=GAUSS_THRESHOLDS, bar=False))
    events, device_us = device_table(prof)
    run = main_path["gauss2d smc"]
    nb = res.n_batches
    check(nb == run["n_batches"], "gauss2d SMC: the profiled run differs")
    run["device_ms_per_batch"] = device_us / 1e3 / nb
    run["busy_share"] = device_us / 1e6 / run["seconds"]
    (OUT_DIR / "profile_gauss2d_smc.txt").write_text(events.table(
        sort_by="self_device_time_total", row_limit=30))
    log(f"profile gauss2d smc: device {run['device_ms_per_batch']!r} "
        f"ms/batch over all {nb} batches of {GAUSS_BATCH}; main run "
        f"{run['seconds'] * 1e3 / nb!r} ms/batch wall, so the device is "
        f"busy {run['busy_share']!r} of it; table in "
        "build/profiles/profile_gauss2d_smc.txt")
    log_top(events, device_us, nb)


CAPTURE_LIMIT_S = 150.0
CAPTURE_CHUNKS = (3, 6)       # chunks of the two profiled rejection runs
CAPTURE_KERNEL_REPS = 20      # kernel launches in one timed graph


def capture_modes(fn):
    """``fn(mode)`` for mode "eager" (``capture._ENABLED = False``) then
    "captured", in one process; returns {mode: result}."""
    from elfi_tpu_torch.utils import capture
    out = {}
    for mode in ("eager", "captured"):
        capture._ENABLED = mode == "captured"
        try:
            out[mode] = fn(mode)
        finally:
            capture._ENABLED = True
    return out


def launch_calls(prof):
    """Host launches of a profile that ran on the card (a graph replay is
    one)."""
    return len(executed_launches(prof.profiler.kineto_results.events()))


def cull_kernels_per_merge(events, merges):
    """The cull's device kernels (scan and merge) per merge in a profile."""
    n = sum(e.count for e in card_events(events) if "cull_" in e.key)
    return n / max(merges, 1)


def loop_graphs(sampler, proposals=False):
    """The CUDA graphs of a sampler's fused loop: its program's (with
    ``proposals``, an SMC's rounds >= 1's)."""
    from elfi_tpu_torch.compile.compiler import compile_program
    return compile_program(
        sampler.model, tuple(sampler.output_names),
        override_names=tuple(sorted(sampler.parameter_names))
        if proposals else (), device=sampler.device).replays


def capture_rejection(device, name, node, batch, seed, threshold=None):
    """Captured against eager on one rejection path: the runs equal bit
    for bit, and per mode the wall, device ms and busy share of a steady
    run, the host launches a chunk (two profiled runs of CAPTURE_CHUNKS
    chunks on one sampler, differenced), the captures and K1/K2/cull
    launches inside graphs."""
    import elfi_tpu_torch as et
    from elfi_tpu_torch.methods.samplers import _FUSED_CHUNK
    from elfi_tpu_torch.ops.kernels.gnk import gnk_distance
    from elfi_tpu_torch.ops.kernels.ma2 import ma2_distance
    from elfi_tpu_torch.ops.kernels.topn import topn_cull
    c1, c2 = (c * _FUSED_CHUNK * batch for c in CAPTURE_CHUNKS)
    kw = {} if threshold is None else dict(threshold=threshold)

    def run(mode):
        rej = et.Rejection(node, batch_size=batch, seed=seed, device=device)
        sample = (lambda n_sim: rej.sample(N_SAMPLES, n_sim=n_sim,
                                           bar=False)) if threshold is None \
            else (lambda n_sim: rej.sample(N_SAMPLES, bar=False, **kw))
        sample(c1)                      # records, captures
        reset_counts(ma2_distance, gnk_distance, topn_cull)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sample(c2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {f.__name__: dict(host=f.launches, in_graphs=f.graph_launches)
                  for f in (ma2_distance, gnk_distance, topn_cull)}
        out = dict(result=res, wall_s=wall, counts=counts,
                   batches=res.n_batches)
        if threshold is not None:
            return out
        profs = []
        for n_sim in (c1, c2):
            merges0 = ran(topn_cull)
            _, prof = profiled(lambda: sample(n_sim))
            events, us = device_table(prof)
            profs.append((launch_calls(prof), us, events,
                          ran(topn_cull) - merges0))
        (l1, u1, _, _), (l2, u2, events, merges) = profs
        chunks = CAPTURE_CHUNKS[1] - CAPTURE_CHUNKS[0]
        out.update(device_ms=u2 / 1e3, busy_share=u2 / 1e3 / (wall * 1e3),
                   host_launches_per_chunk=(l2 - l1) / chunks,
                   device_ms_per_chunk=(u2 - u1) / 1e3 / chunks,
                   captures=loop_graphs(rej).captures,
                   cull_kernels_per_merge=cull_kernels_per_merge(
                       events, merges))
        return out

    modes = capture_modes(run)
    e, c = modes["eager"], modes["captured"]
    names = [k for k in e["result"].outputs]
    check_equal_samples(c["result"], e["result"], f"{name}: captured and "
                        "eager", names)
    check(c["batches"] == e["batches"], f"{name}: batch counts differ")
    for mode in modes.values():
        del mode["result"]
    if threshold is None:
        check(c["counts"]["topn_cull"]["in_graphs"] > 0,
              f"{name}: no merge ran inside a graph")
    log(f"capture, {name}: captured equals eager bit for bit; "
        + "; ".join(f"{m}: {v!r}" for m, v in modes.items()))
    return modes


def capture_smc(device, name, node, batch, n, **kw):
    """Captured against eager on one SMC path: populations and weights
    equal bit for bit; per mode the wall of a run (captures included), its
    device ms and busy share from a profiled run, host launches a chunk,
    captures, the chunks run again for a redraw (in the warm-up and in
    the timed run) and the redraw rounds the timed run's graphs held."""
    import elfi_tpu_torch as et
    from elfi_tpu_torch.methods.samplers import _FUSED_CHUNK
    from elfi_tpu_torch.ops.kernels.ma2 import ma2_distance

    def run(mode):
        make = (lambda: et.SMC(node, batch_size=batch, seed=4,
                               device=device))
        _, _, warm = timed_smc(make, n, **kw)   # warm-up: records, captures
        graphs = loop_graphs(warm, proposals=True)
        captures0, replays0 = graphs.captures, graphs.replays
        reset_counts(ma2_distance)
        res, wall, smc = timed_smc(make, n, **kw)
        k1 = dict(host=ma2_distance.launches,
                  in_graphs=ma2_distance.graph_launches)
        (prof_res, _, psmc), prof = profiled(lambda: timed_smc(make, n, **kw))
        events, us = device_table(prof)
        chunks = sum(-(-p.meta["n_batches"] // _FUSED_CHUNK)
                     for p in prof_res.populations)
        return dict(result=res, wall_s=wall, device_ms=us / 1e3,
                    busy_share=us / 1e3 / (wall * 1e3),
                    host_launches_per_chunk=launch_calls(prof) / chunks,
                    captures=graphs.captures - captures0,
                    replays=graphs.replays - replays0,
                    redone_chunks=(warm.state.get("redone_chunks", 0),
                                   smc.state.get("redone_chunks", 0)),
                    redraw_rounds=smc.state.get("redraw_rounds", 0),
                    k1=k1, batches=res.n_batches)

    modes = capture_modes(run)
    e, c = modes["eager"]["result"], modes["captured"]["result"]
    check(len(e.populations) == len(c.populations),
          f"{name}: round counts differ")
    for pe, pc in zip(e.populations, c.populations):
        check_equal_samples(pc, pe, f"{name}: captured and eager")
        check(np.array_equal(pc.weights, pe.weights),
              f"{name}: the weights differ")
    for mode in modes.values():
        del mode["result"]
    # gauss2d's proposals stay inside its wide prior, so its graphs hold
    # no redraw round; MA2's leave the triangle, so its warm-up learns the
    # rounds from its eager proposal chunks, and the timed run, the same
    # seed's proposals, replays its rounds' chunks with none run again
    c = modes["captured"]
    gauss2d = name.startswith("gauss2d")
    check(c["replays"] > 0, f"{name}: no chunk of a round >= 1 replayed")
    check(c["redone_chunks"][1] == 0 and (
        c["redone_chunks"][0] == 0 if gauss2d else True),
        f"{name}: {c['redone_chunks']} chunks redone (warm-up, timed)")
    check(c["redraw_rounds"] == 0 if gauss2d else c["redraw_rounds"] > 0,
          f"{name}: graphs held {c['redraw_rounds']} redraw rounds")
    scope = ("every chunk of its rounds replayed, no redraw round" if
             gauss2d else f"{c['redraw_rounds']} redraw rounds learned, "
             "every chunk of its rounds replayed")
    log(f"capture, {name} ({scope}): captured equals eager bit for bit; "
        + "; ".join(f"{m}: {v!r}" for m, v in modes.items()))
    return modes


def capture_bsl(device):
    """The BSL chain at the bench's point captured against eager: the
    chain bit for bit, ms a step, device ms a step and busy share, host
    launches a step, captures."""
    import elfi_tpu_torch as et
    from elfi_tpu_torch.methods.bsl import standard_likelihood
    from elfi_tpu_torch.models import ma2
    m = ma2.get_model(seed_obs=SEED_OBS)
    lik = standard_likelihood(shrinkage="warton", penalty=0.3)

    def chain(seed, n_steps):
        b = et.BSL(m, n_sim_round=BSL_N_SIM_ROUND, feature_names=["S1", "S2"],
                   likelihood=lik, seed=seed, device=device)
        return b, b.sample(n_steps, **BSL_SAMPLE_KW)

    def run(mode):
        chain(3, 33)                                        # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b, res = chain(4, BSL_N)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        # a step's launches and device ms: two profiled chains, differenced
        # (1 + 2 x 16 and 1 + 6 x 16 steps: whole blocks of _CHAIN_BLOCK)
        (n1, n2), profs = (33, 97), []
        for n_steps in (n1, n2):
            _, prof = profiled(lambda: chain(4, n_steps))
            profs.append((launch_calls(prof), device_table(prof)[1]))
        (l1, u1), (l2, u2) = profs
        device_ms = (u2 - u1) / 1e3 / (n2 - n1)
        return dict(result=res, ms_per_step=wall * 1e3 / BSL_N,
                    device_ms_per_step=device_ms,
                    busy_share=device_ms / (wall * 1e3 / BSL_N),
                    host_launches_per_step=(l2 - l1) / (n2 - n1),
                    captures=b._chain_replays.captures,
                    replays=b._chain_replays.replays)

    modes = capture_modes(run)
    e, c = modes["eager"]["result"], modes["captured"]["result"]
    for k in e.samples_all:
        check(np.array_equal(c.samples_all[k], e.samples_all[k]),
              f"BSL: captured and eager chains differ in {k}")
    for mode in modes.values():
        del mode["result"]
    check(modes["captured"]["captures"] == 1, "BSL: not one capture a run")
    log("capture, ma2 bsl: captured equals eager bit for bit; "
        + "; ".join(f"{m}: {v!r}" for m, v in modes.items()))
    return modes


def capture_kernel_times(device):
    """K1 and K2 at the main path's shapes: CAPTURE_KERNEL_REPS launches
    keyed from device memory inside one graph against as many launches
    keyed by value, queued ahead, in turns (eager, graph, graph, eager);
    ms a launch."""
    from elfi_tpu_torch.ops.kernels.gnk import gnk_distance
    from elfi_tpu_torch.ops.kernels.ma2 import ma2_distance
    from elfi_tpu_torch.utils import capture
    t1, t2 = prior_params(KERNEL_BATCH, device, seed=1)
    obs = observed_autocovs(device)
    A, B, g, k = gnk_prior_params(GNK_BATCH, device, seed=1)
    gobs = gnk_observed_sorted(GNK_N_OBS, device)
    seed = 0x123456789ABCDEF
    key = torch.tensor(capture.pack_keys([seed]), device=device)
    calls = {
        "ma2_distance": lambda key: ma2_distance(
            t1, t2, obs, n_obs=N_OBS, batch_size=KERNEL_BATCH, key=key),
        "gnk_distance": lambda key: gnk_distance(
            A, B, g, k, gobs, n_obs=GNK_N_OBS, batch_size=GNK_BATCH,
            key=key)}
    out = {}
    for name, call in calls.items():
        check(torch.equal(call(seed), call(key)),
              f"{name}: keyed from device memory differs")
        with capture.on_side_stream(device):
            call(key)
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin()
            outs = [call(key) for _ in range(CAPTURE_KERNEL_REPS)]
            graph.capture_end()
        graph.replay()
        check(all(torch.equal(o, call(seed)) for o in outs),
              f"{name}: the graph's launches differ from eager")

        def eager():
            for _ in range(CAPTURE_KERNEL_REPS):
                call(seed)
        times = {"eager": [], "graph": []}
        for mode in ("eager", "graph", "graph", "eager"):
            fn = eager if mode == "eager" else graph.replay
            times[mode].append(queued_ms(fn, reps=10)
                               / CAPTURE_KERNEL_REPS)
        e = statistics.median(times["eager"])
        gm = statistics.median(times["graph"])
        out[name] = dict(eager_ms=e, graph_ms=gm, ratio=gm / e)
        del graph, outs
    log(f"capture, kernels in a graph (keyed from device memory) against "
        f"eager (keyed by value): {out!r}")
    return out


def phase_capture(device):
    """The CUDA graphs (``utils.capture``): every captured path against
    the same path run eagerly in this process, bit for bit, with walls,
    device ms, busy shares, host launches a chunk and captures; K1 and K2
    inside a graph against eager; ``CompiledProgram.jitted`` against
    ``traceable``."""
    import elfi_tpu_torch as et
    from elfi_tpu_torch.compile.compiler import compile_program
    from elfi_tpu_torch.models import gauss, gnk_kernel, ma2, ma2_kernel
    from elfi_tpu_torch.ops.kernels.ma2 import ma2_distance
    t0 = time.perf_counter()
    out = {}
    walls = out["path_walls_s"] = {}

    def timed_path(name, fn, *args, **kw):
        t = time.perf_counter()
        out[name] = fn(*args, **kw)
        walls[name] = time.perf_counter() - t

    plain = ma2.get_model(seed_obs=SEED_OBS)["d"]
    kern = ma2_kernel.get_model(seed_obs=SEED_OBS)["d"]
    for name, node, batch in (
            ("ma2 rejection plain graph", plain, PLAIN_BATCH),
            ("ma2 rejection kernel graph", kern, KERNEL_BATCH),
            ("gnk rejection kernel graph", gnk_kernel.get_model(
                n_obs=GNK_N_OBS, seed_obs=GNK_SEED_OBS)["d"], GNK_BATCH)):
        timed_path(name, capture_rejection, device, name, node, batch, 1)
    for name, node in (("plain", plain), ("kernel", kern)):
        timed_path(f"ma2 rejection {name} graph, threshold",
                   capture_rejection, device,
                   f"ma2 rejection {name} graph, threshold 0.1", node,
                   2**16, 2, threshold=0.1)
    g2 = gauss.get_model(**GAUSS_KW)
    timed_path("gauss2d smc", capture_smc, device, "gauss2d smc", g2["d"],
               GAUSS_BATCH, GAUSS_N, thresholds=GAUSS_THRESHOLDS)
    # MA2 SMC on the kernel graph (the plain graph's rounds run as its
    # do: with the redraw rounds learned in the warm-up, replayed)
    timed_path("ma2 smc kernel graph", capture_smc, device,
               "ma2 smc kernel graph", kern, SMC_BATCH, 500,
               quantiles=[0.5, 0.2, 0.2])
    timed_path("ma2 bsl", capture_bsl, device)
    timed_path("kernels in a graph", capture_kernel_times, device)

    # jitted: the per-batch program replayed against traceable
    prog = compile_program(ma2_kernel.get_model(seed_obs=SEED_OBS),
                           ("t1", "t2", "d"), device=device)
    reset_counts(ma2_distance)
    for seed, b in ((1, 0), (1, 1), (1, 2), (2, 7), (3, 2**40)):
        got = prog.run(seed, b, batch_size=KERNEL_BATCH)
        want = prog.traceable(KERNEL_BATCH)(seed, b, {})
        for k in want:
            check(torch.equal(got[k], want[k]),
                  f"jitted: {k} at ({seed}, {b}) differs from traceable")
    out["jitted"] = dict(k1_host=ma2_distance.launches,
                         k1_in_graphs=ma2_distance.graph_launches)
    check(ma2_distance.graph_launches == 4, "jitted: K1 not replayed")
    out["wall_s"] = time.perf_counter() - t0
    log(f"capture phase: {out['wall_s']!r} s (limit {CAPTURE_LIMIT_S}); "
        f"by path {walls!r}")
    check(out["wall_s"] < CAPTURE_LIMIT_S, "the capture phase is too slow")
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available; this "
                         "check runs the port on a GPU only")
    device = torch.device("cuda", 0)
    card = card_line()
    log(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}"
        f", CUDA {torch.version.cuda}")
    log(f"card: {card}")

    from elfi_tpu_torch.ops.kernels import _build
    from elfi_tpu_torch.ops.kernels import gnk as k2
    from elfi_tpu_torch.ops.kernels import ma2 as k1
    from elfi_tpu_torch.ops.kernels import topn
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=3) as pool:
        for built in [pool.submit(k._lib) for k in (k1, k2, topn)]:
            built.result()
    log(f"built K1, K2 and the cull in {time.perf_counter() - t0!r} s (one "
        f"nvcc each, in parallel)")
    ptxas = {}
    for lib in ("ma2_distance", "gnk_distance", "topn_cull"):
        log(f"nvcc {lib}: {_build.build_log[lib]['seconds']!r} s")
        log(_build.build_log[lib]["log"].strip())
        ptxas[lib] = ptxas_entries(_build.build_log[lib]["log"])
        check(len(ptxas[lib]) > 0, f"no ptxas -v lines for {lib}")
        for name, regs, stores, loads, frame in ptxas[lib]:
            check(stores == loads == frame == 0, f"{name}: {stores} bytes "
                  f"of spill stores, {loads} of spill loads, {frame} of "
                  "stack frame")
        log(f"ptxas {lib}: " + "; ".join(
            f"{name} {regs} registers" for name, regs, *_ in ptxas[lib])
            + "; no spills, no stack frame")

    k1_checks = phase_kernel_checks(device)
    phase_fused_equals_batchwise(device)
    main_path = phase_main_path(device)
    merge = phase_merge(device)
    k2_checks = phase_gnk_kernel_checks(device)
    main_path.update(phase_gnk_main_path(device))
    observed = phase_observed(device)
    main_path["observed"] = observed
    adaptive = phase_adaptive(device)
    phase_smc_proposals(device)
    main_path["gauss2d smc"] = phase_gauss_smc(device)
    main_path.update(phase_ma2_smc(device))
    adaptive.update(phase_adaptive_smc(device))
    phase_profile(device, main_path)
    main_path["ma2 bsl"] = phase_bsl()
    captured = phase_capture(device)
    main_path["ricker bolfi"] = phase_bolfi()
    main_path["gnk bolfire"] = phase_bolfire()
    main_path["variance acquisitions"] = phase_variance_acquisitions()
    main_path["romc gnk"] = phase_romc()
    main_path["zoo"] = phase_zoo(device)
    main_path["host"] = phase_host(device)
    t_new = time.perf_counter()
    main_path["pool"] = phase_pool(device)
    main_path["persistence and aux"] = phase_persistence_aux(device)
    main_path["distributions"] = phase_distributions(device)
    log(f"pool, persistence/aux and distributions phases: "
        f"{time.perf_counter() - t_new!r} s")
    default_device = phase_default_device()
    backends = phase_backends(device)
    main_path["backends"] = backends

    log(json.dumps({"main_path": main_path,
                    "merge_ms": {**{k: v for k, v in k1_checks.items()
                                    if k.startswith("merge_ms")},
                                 f"gnk_{GNK_BATCH}": k2_checks["merge_ms"]},
                    "merge": merge,
                    "adaptive": adaptive,
                    "capture": captured,
                    "card": card}))
    pool_launches = main_path["pool"]["launches"]
    bl = backends["launches"]
    k1_backends = {
        "ma2 rejection over the device list": bl["list rejection"],
        "ma2 smc over the device list": bl["list smc"],
        "ma2 rejection, cluster master with no worker": bl["cluster local"],
        "ma2 rejection, multihost rank 0": bl["multihost rank 0"],
        "ma2 rejection, multihost rank 1": bl["multihost rank 1"]}
    obs_k1 = observed["ma2 kernel graph, seed_obs 1"]
    obs_k2 = observed["gnk kernel graph, seed_obs 4"]
    k1_launches = (main_path["kernel graph"]["launches"]
                   + obs_k1["launches"]
                   + main_path["ma2 smc kernel graph"]["launches"]
                   + sum(pool_launches.values())
                   + sum(k1_backends.values()))
    bm = backends["merge_launches"]
    cull_by_path = {
        "ma2 rejection plain graph":
            main_path["plain graph"]["merge_launches"],
        "ma2 rejection kernel graph":
            main_path["kernel graph"]["merge_launches"],
        "gnk rejection plain graph":
            main_path["gnk plain graph"]["merge_launches"],
        "gnk rejection kernel graph":
            main_path["gnk kernel graph"]["merge_launches"],
        "ma2 rejection kernel graph, seed_obs 1":
            obs_k1["merge_launches"],
        "gnk rejection kernel graph, seed_obs 4":
            obs_k2["merge_launches"],
        "ma2 smc plain graph":
            main_path["ma2 smc plain graph"]["merge_launches"],
        "ma2 smc kernel graph":
            main_path["ma2 smc kernel graph"]["merge_launches"],
        "gauss2d smc": main_path["gauss2d smc"]["merge_launches"],
        "ma2 rejection, no device given": default_device["merge_launches"],
        "ma2 pooled rejection, replay and extension":
            main_path["pool"]["merge_launches"],
        "ma2 rejection over the device list": bm["list rejection"],
        "ma2 smc over the device list": bm["list smc"],
        "gnk rejection over the device list": bm["list gnk"]}
    k1_bound, k1_by = bound_ms(k1_ops(N_OBS), 12, KERNEL_BATCH)
    k2_bound, k2_by = bound_ms(k2_ops(GNK_N_OBS), 20, GNK_BATCH)
    log(json.dumps({"kernels": [{
        "name": "ma2_distance",
        "route": "cuda",
        "source": "elfi_tpu_torch/csrc/ma2_distance.cu",
        "replaces": "elfi_tpu/ops/pallas_kernels.py:71",
        "launches": k1_launches,
        "launches_by_path": {
            "ma2 rejection kernel graph":
                main_path["kernel graph"]["launches"],
            "ma2 rejection kernel graph, seed_obs 1 (generated data)":
                obs_k1["launches"],
            "ma2 smc kernel graph":
                main_path["ma2 smc kernel graph"]["launches"],
            "ma2 rejection, no device given": default_device["launches"],
            "ma2 pooled rejection": pool_launches["pooled"],
            "ma2 pooled replay": pool_launches["replay"],
            "ma2 pooled extension": pool_launches["extension"],
            **k1_backends},
        "max_abs_err": k1_checks["max_abs_err"],
        "max_rel_err": k1_checks["max_rel_err"],
        "ms": k1_checks["ms"],
        "plain_ms": k1_checks["plain_ms"],
        "bound_ms": k1_bound,
        "bound_by": k1_by,
        "bound_share": k1_bound / k1_checks["ms"],
        "ops_per_sim": k1_ops(N_OBS),
        "library_ms": None,
        "ptxas": ptxas["ma2_distance"],
        "graph_ms": captured["kernels in a graph"]["ma2_distance"][
            "graph_ms"],
    }, {
        "name": "gnk_distance",
        "route": "cuda",
        "source": "elfi_tpu_torch/csrc/gnk_distance.cu",
        "replaces": "elfi_tpu/ops/pallas_kernels.py:157",
        "launches": (main_path["gnk kernel graph"]["launches"]
                     + obs_k2["launches"] + bl["list gnk"]),
        "launches_by_path": {
            "gnk rejection kernel graph":
                main_path["gnk kernel graph"]["launches"],
            "gnk rejection kernel graph, seed_obs 4 (generated data)":
                obs_k2["launches"],
            "gnk rejection over the device list": bl["list gnk"]},
        "max_abs_err": k2_checks["max_abs_err"],
        "max_rel_err": k2_checks["max_rel_err"],
        "ms": k2_checks["ms"],
        "plain_ms": k2_checks["plain_ms"],
        "bound_ms": k2_bound,
        "bound_by": k2_by,
        "bound_share": k2_bound / k2_checks["ms"],
        "ops_per_sim": k2_ops(GNK_N_OBS),
        "library_ms": None,
        "ptxas": ptxas["gnk_distance"],
        "graph_ms": captured["kernels in a graph"]["gnk_distance"][
            "graph_ms"],
    }, {
        "name": "topn_cull",
        "route": "cuda",
        "source": "elfi_tpu_torch/csrc/topn_cull.cu",
        "replaces": "elfi_tpu/ops/topk.py:74 (XLA, not Pallas)",
        "launches": sum(cull_by_path.values()),
        "launches_by_path": cull_by_path,
        "max_abs_err": merge["max_abs_err"],
        "ms": merge["ms"],
        "plain_ms": merge["plain_ms"],
        "bound_ms": merge["bound_ms"],
        "bound_by": "bytes",
        "bound_share": merge["bound_ms"] / merge["ms"],
        "library_ms": merge["library_ms"],
        "ptxas": ptxas["topn_cull"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--multihost-rank"]:
        # a helper process of the backends phase, started by that phase
        sys.exit(multihost_rank(int(sys.argv[2]), *sys.argv[3:8]))
    sys.exit(main())
