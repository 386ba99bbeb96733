#!/usr/bin/env python3
"""Drive the PyTorch port (the iLEQG solver bank on the unicycle, the
cartpole, the n=12 quadrotor and a problem with no tile model, RAT iLQR,
RAT iLQR++, PETS, the MPC driver, seed-batched MPC fleets and the
distributed layer) on one CUDA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.

Phases (each prints a line and raises on failure):
  1. device: the card's name and power limit; exits non-zero without CUDA;
  2. build: compiles the CUDA kernels from ratilqr_tpu_torch/csrc (one nvcc
     per source, in parallel) and prints each kernel's registers, spills
     and stack frame, and kernels A's, B's, C's and D's one-solve-per-team
     kernels (the quadrotor) with their shared memory a block, and kernels
     B's and C's few-lane kernels at n <= 4 (each model and K, f32 and
     f64) with the lanes a solve and shared memory their launch takes at
     the widths of the paths below; then builds
     kernel A at (6, 3) and kernel D at n=6,
     shapes outside the shipped library, float32 and float64, and prints
     each unit's build time and ptxas report;
  3. every kernel against its plain PyTorch version on the card, float32
     and float64, at the unicycle T=100, the LQR T=7, the quadrotor T=50
     and the cartpole T=50 with B=1, B=5 and B=4,099 (kernel D with a shared
     and a per-lane noise model), kernels A and D on the random linear
     problem at (6, 3), T=20, kernels A and B on the n=12 h_fail fixture
     (``kernel_check.H_FAIL``), kernel A's slim optimizing pass and
     kernel D (a shared and a per-lane noise model) on the quadrotor at
     B=262,144 in float32, kernels A and C on the unicycle T=30 at the
     fleets' widths (B=256 and 640), kernels B and C on the unicycle, LQR
     and the cartpole at the first width whose launch takes 1 lane a solve
     (read from the launch's own query; the widths above take 4), kernel
     B on the cartpole's h_fail fixture, the θ = 1e6 lanes latching m_fail
     and the h_fail fixtures' lanes h_fail; and kernels B and C on the
     near-breakdown fixture (the cartpole T=20, B=33,793, f32), whose fail
     flags must equal the plain version's on every lane;
  4. the unicycle bank at full width — the warm-started bank (T=100, bench
     configuration) cold and warm at B=16,384, warm at B=262,144, and a
     warm re-plan of at most 3 iterations in the default configuration at
     B=1,024 — with the kernels' launch counts read around it;
  5. 64 lanes of the B=16,384 bank again on the CPU through the plain path;
  6. the model-size bank path: the quadrotor (n=12, m=4, T=50, f32) through
     ``make_batched_solver`` in three configurations — (a) default step and
     fused candidate (kernels A + C), cold and warm at B=16,384; (b) fused
     step and candidate (B + C), cold and warm at B=16,384 and warm at
     B=262,144; (c) RAT iLQR's inner configuration (B + D), warm at
     B=16,384 — with the launch counts read around each run, and 64 lanes
     of (b) in float64 on the card and on the CPU through the plain path;
     then the cartpole (n=4, m=1, T=50, f32), cold from x0 = (0.3, 0, 0.4,
     0): (a), (b) and (c) at B=16,384 and (b) at B=262,144 with 0 failed
     lanes; the JAX bench cell's x0 = 0 (every θ > 0 lane fails at
     iteration 0), its failure pattern on 64 lanes held against the CPU;
     and 64 lanes of (b) in float64 on the card and on the CPU;
  6b. any problem: the random linear problem at (6, 3) with no tile model,
     T=20, B=4,099, in the default configuration (kernel A), with the fused
     flags (their composition: kernels A and D) and with the folded
     candidate evaluation (A and D), 64 lanes of each against the CPU in
     float64, and one bank from numpy inputs on a problem on the card;
  7. the RAT iLQR path: ``MPCDriver`` planning the unicycle (T=100,
     f32) twice (cold, then warm) through ``RATiLQRSolver`` and once
     (cold) through the single-call ``ratilqr_jit.solve``, on the folded
     candidate evaluation (kernel D)
     and the fused step (kernel B), with the launch counts read around
     each path;
  7b. the RAT iLQR++ path: ``MPCDriver`` re-planning the unicycle (T=30,
     f32, inner ``iter_max=30`` with the fused candidate: kernels A and C)
     through each entry point — once on the host path with
     ``refresh_carried_costs`` (one-lane banks) and on the single-call
     path at reference semantics, twice on the single-call path with
     refresh, both at speculation depth 3 —
     with each re-plan's θ_opt, NM iterations, banks and their widths,
     host syncs and launches; whether the single-call path's carried final
     lane equals a fresh one-lane solve in f32; then one cold solve in
     float64 through the host path and the single-call path (depth 3), on
     the card and on the CPU, which must take the same decisions;
  8. one CE generation at width (16,384 θ samples), timed and profiled
     (device idle share), and 64 of its θ again in float64 on the card and
     on the CPU through the plain path;
  8b. PETS: ``gmm_integrator`` (T=50, f32) at K=1,024 control sequences x
     M=16 rollouts, one ``solve`` of 5 generations timed (median of 3) and
     profiled under both models; then the uniform PETS fixture in float64
     on the card and on the CPU with the same control draws (μ, Σ within
     1e-12);
  8c. MPC fleets (``mpc_episode``, seeds as bank lanes; the unicycle at
     T=30, f32, kernels A + C): the iLEQG fleet of 256 seeds x 3 steps
     timed (one run after its warm-up) with its host syncs, launches and
     (over its first step) idle share, a host-loop comparator (one step,
     scaled), and seeds 0-3 against one-seed episodes under the f32 rule;
     the RAT iLQR fleet of 64 seeds (banks of 640 lanes) over 1 step;
     both fleets in float64 on the card
     and on the CPU with the same generators; the RAT fleet's state
     through a checkpoint, continued bit for bit; ``ILEQGBankServer`` on
     5,000 requests against one direct bank, bit for bit;
  8d. sharded: the distributed layer (``ratilqr_tpu_torch.parallel``) on
     an NCCL group of one rank in this process — the θ-bank of the bench
     configuration at B=262,144, PETS at pets_16k through both elite
     paths, the iLEQG fleet of 256 seeds x 1 step — and the θ-bank at
     B=16,384 on two spawned gloo ranks sharing the card, each equal bit
     for bit to its unsharded run; then the parallel-in-time Riccati DP
     against kernel A on the unicycle (B=16, T=1,000 and 4,000): float64
     parity, both times in float64 and float32, the float32 error;
  9. timings: each kernel's wrapper, its launch alone and its plain
     version, beside its bound, on the unicycle (B=262,144; T=30 at
     RAT iLQR++'s widths B=1 and 942), the quadrotor (B=16,384 and
     262,144) and the cartpole (B=16,384); kernel B's launch alone at RAT
     iLQR's width (the unicycle T=100, B=10) and kernel C's at the fleets'
     widths (the unicycle T=30, B=256 and 640); warm solves/s.
The CPU halves of the card-vs-CPU checks (phases 5, 6, 6b, 7b, 8 and 8c)
depend on nothing the card computes: they run from the start in
``CPU_WORKERS`` spawned worker processes while the card works, and the
script prints how long each took and when it ended.  The line before the
card's name is the JSON kernel record; the last line is the JSON device
record.
"""
import concurrent.futures
import itertools
import json
import multiprocessing
import os
import queue
import socket
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from ratilqr_tpu_torch import (CrossEntropyConfig, ILEQGBankServer,
                               ILEQGConfig, MPCDriver, NelderMeadConfig,
                               PETSConfig, RATiLQRSolver, kernel_check,
                               load_state, make_batched_solver,
                               make_episode_runner, make_fleet_runner,
                               make_gaussian_simulator, make_ileqg_plan,
                               make_ratilqr_plan, plan_without_generator,
                               save_state, tests_support)
from ratilqr_tpu_torch import parallel
from ratilqr_tpu_torch.models import (cartpole, gmm_integrator, quadrotor,
                                      unicycle)
from ratilqr_tpu_torch.ops import (_build, candidate_cuda, riccati_cuda,
                                   step_cuda, tile_model)
from ratilqr_tpu_torch.ops.approx import Approximation, approximate_model
from ratilqr_tpu_torch.ops.riccati import dp_optimize
from ratilqr_tpu_torch.ops.riccati_parallel import dp_optimize_parallel
from ratilqr_tpu_torch.ops.rollout import rollout_open_loop_with_jac
from ratilqr_tpu_torch.solvers import (ileqg, nelder_mead, nelder_mead_jit,
                                       pets, ratilqr, ratilqr_jit)
from ratilqr_tpu_torch.solvers.ratilqr import solve_one
from ratilqr_tpu_torch.utils.profiling import (count_host_syncs,
                                                device_busy, time_fn)
from ratilqr_tpu_torch.utils.tree import tree_map

T = 100
B_MAIN = 16_384
B_WIDE = 262_144
B_DEFAULT = 1_024
X_MPC = (0.05, -0.03, 0.01)
BENCH_CONFIG = ILEQGConfig(iter_max=100, d_tol=1e-2, adaptive_eps_init=True,
                           eps_history_cap=0, fused_candidate_eval=True,
                           fused_step_optimize=True)
# The model-size bank path, benchmarks/run_all.py:278-306: quadrotor(N=50)
# in f32, x0 = 0, u0 = 0, θ = linspace(0, 0.01, B), warm-started from the
# cold solve's l[0]; (c) is RAT iLQR's inner configuration below.
QUAD_T = 50
QUAD_THETA_MAX = 0.01
QUAD_BASE = dict(eps_history_cap=0, adaptive_eps_init=True,
                 fused_candidate_eval=True)
# RAT iLQR: examples/mpc_unicycle.py:56-57 at the bench horizon, on the
# folded candidate evaluation with the chunked ε ladder.
RAT_INNER = ILEQGConfig(iter_max=30, adaptive_eps_init=True,
                        eps_history_cap=0, fused_step_optimize=True,
                        fold_candidate_eval=True, ls_chunk=4)
MODEL_CONFIGS = {   # name: (config, the kernels its path must run)
    "a": (ILEQGConfig(**QUAD_BASE), ("riccati", "candidate")),
    "b": (ILEQGConfig(**QUAD_BASE, fused_step_optimize=True),
          ("step", "candidate")),
    "c": (RAT_INNER, ("step", "riccati_folded")),
}
RAT_CONFIG = CrossEntropyConfig(
    num_samples=10, num_elite=3, iter_max=5, mu_init=0.005, sigma_init=0.01,
    ileqg=RAT_INNER)
KL_BOUND = 0.05
# Re-plans a RAT iLQR entry point, cut for the time limit (the cold
# re-plan alone takes 20-30 s): a cold and a warm one on the host path.
N_REPLANS = {"ratilqr": 2, "ratilqr_jit": 1}
B_CE = 16_384   # one CE generation at the bank size of the bank's path
# RAT iLQR++ (benchmarks/run_all.py:121-182): the unicycle at T=30 in f32,
# inner iter_max=30 with the fused candidate (kernels A + C), kl_bound 0.05.
NM_T = 30
NM_KL = 0.05
NM_INNER = ILEQGConfig(iter_max=30, fused_candidate_eval=True)
NM_KERNELS = ("riccati", "candidate")
NM_PATHS = {   # name: (solve, refresh_carried_costs, speculation_depth,
               #        re-plans; cut for the time limit: the host path's
               #        one-lane banks take ~50 s a re-plan, and the third
               #        re-plan at reference semantics ~60 s, 100 NM
               #        iterations on a stale c_low)
    "nm_host_refresh": (nelder_mead.solve, True, 1, 1),
    "nm_single_d3": (nelder_mead_jit.solve, False, 3, 1),
    "nm_single_refresh_d3": (nelder_mead_jit.solve, True, 3, 2),
}
NM_WIDTHS = (1, 942)   # the kernels' widths timed on the NM path
# PETS, the JAX bench's pets_16k cell (benchmarks/run_all.py:255-275).
PETS_T = 50
PETS_CONFIG = PETSConfig(num_control_samples=1024, num_trajectory_samples=16,
                         num_elite=32, iter_max=5)
# MPC fleets, benchmarks/run_all.py:178-252: the unicycle at T=30 in f32,
# x0 = 0, u0 = 0, the Gaussian simulator, inner iter_max=30 with the fused
# candidate (kernels A + C); seeds are bank lanes.
FLEET_T = 30
FLEET_CONFIG = ILEQGConfig(iter_max=30, eps_history_cap=0,
                           fused_candidate_eval=True)
FLEET_KERNELS = ("riccati", "candidate")
FLEET_SEEDS, FLEET_STEPS = 256, 3        # iLEQG at θ = 0
FLEET_TIMED = 1          # timed runs after the warm-up (cut for the limit)
FLEET_PROFILED = 1       # steps of the profiled run (idle share)
FLEET_CHECKED = (4, 2)   # seeds 0-3 against one-seed episodes, 2 steps
RAT_FLEET_CONFIG = CrossEntropyConfig(num_samples=10, iter_max=5,
                                      mu_init=0.005, sigma_init=0.01,
                                      ileqg=FLEET_CONFIG)
RAT_FLEET_SEEDS = 64
RAT_FLEET_STEPS = 1      # run_all.py runs 10; cut for the time limit
FLEET_KL = 0.05
FLEET64 = {"ileqg": (8, 3), "ratilqr": (4, 2)}   # (seeds, steps), f64
# The widths of the fleets' banks (seeds; seeds x CE samples), at which
# phase 3 also holds kernels A and C against their plain versions.
FLEET_WIDTHS = (FLEET_SEEDS,
                RAT_FLEET_SEEDS * RAT_FLEET_CONFIG.num_samples)
# The bank server on the unicycle bench configuration (bench.py:108-111).
SERVE_REQUESTS = 5_000
SERVE_BANK = 2_048
# The sharded phase: the unicycle bench bank (bench.py:90-117) as a CE
# θ-bank on an NCCL group of one rank, and at B_MAIN on two gloo ranks
# sharing the card; the parallel-in-time Riccati DP against kernel A.
SHARDED_CONFIG = CrossEntropyConfig(ileqg=BENCH_CONFIG)
SHARDED_FLEET_STEPS = 1
SHARDED_RANKS = 2
RANK_TIMEOUT_S = 300
PDP_LANES = 16
PDP_HORIZONS = (1_000, 4_000)
PDP_THETA_MAX = 0.01
KERNELS = {   # name: (source, the TPU kernel it replaces)
    "riccati": ("ratilqr_tpu_torch/csrc/riccati.cu",
                "ratilqr_tpu/ops/riccati_pallas.py:193"),
    "step": ("ratilqr_tpu_torch/csrc/step.cu",
             "ratilqr_tpu/ops/step_pallas.py:81"),
    "candidate": ("ratilqr_tpu_torch/csrc/candidate.cu",
                  "ratilqr_tpu/ops/candidate_pallas.py:81 (_candidate_kernel)"
                  " and ratilqr_tpu/ops/candidate_pallas.py:184"
                  " (_candidate_kernel_recompute)"),
    "riccati_folded": ("ratilqr_tpu_torch/csrc/riccati_folded.cu",
                       "ratilqr_tpu/ops/riccati_pallas.py:581"),
}
DESIGNS = {   # how each kernel spreads a bank over the card
    "riccati": ("one solve per team of 16 lanes (two a warp, 8 a block, "
                "working set in shared memory, the next step's streamed "
                "blocks double-buffered by cp.async) at (12, 4), the "
                "quadrotor, and at first-use shapes a team takes (4 < n, "
                "m <= 4, n + m <= 16), e.g. (6, 3); one solve per thread "
                "otherwise: the unicycle, LQR and the cartpole"),
    "step": ("one solve per team of 16 lanes (two a warp, 8 a block, "
             "working set in shared memory) at n=12, the quadrotor; at "
             "n <= 4 (the unicycle, LQR and the cartpole) one solve per "
             "team of K = 4 or 1 lanes of a warp (K picked by the rule "
             "kernel C shares), every lane rolling out and calling the "
             "model in registers, the lanes splitting M's and H's solves "
             "and the DP's products by shuffles; 128 threads a block (64 "
             "at K = 1), no shared memory; the model blocks of step t - 1 "
             "computed during the DP step of step t; M, H and their "
             "factors under the contraction policy"),
    "candidate": ("one solve per team of 16 lanes (two a warp, 8 a block, "
                  "working set in shared memory) at n=12, the quadrotor; at "
                  "n <= 4 (the unicycle, LQR and the cartpole) one solve per "
                  "team of K = 4 or 1 lanes of a warp (K picked from the "
                  "width and the SM count: 4 while that keeps the bank "
                  "within 512 threads an SM), every lane rolling out, "
                  "calling the model and folding in registers, the lanes "
                  "splitting M's solves and the DP's products by shuffles; "
                  "128 threads a block (64 at K = 1); at K = 4 the fold of "
                  "step t - 1 computed during the DP step of step t, and "
                  "each step's streamed inputs and noise model staged in a "
                  "ring of three shared buffers by cp.async; K = 1 (wide "
                  "banks) unstaged, one step at a time"),
    "riccati_folded": ("one solve per team of 16 lanes (two a warp, 8 a "
                       "block, working set in shared memory, the next step's "
                       "streamed blocks double-buffered by cp.async) at "
                       "n=12, the quadrotor, and at first-use n with "
                       "4 < n < 16, e.g. n=6; one solve per thread "
                       "otherwise: the unicycle, LQR and the cartpole")}
SHAPES = {   # the (n, m) each kernel runs on the paths of this script
    "riccati": "(3,2) (2,2) (4,1) (12,4) shipped; (6,3) built at first use",
    "step": "unicycle, LQR, cartpole, quadrotor",
    "candidate": "unicycle, LQR, cartpole, quadrotor",
    "riccati_folded": "n=3 2 4 12 shipped; n=6 built at first use"}
BANK_KERNELS = ("riccati", "step", "candidate")   # phase 4's path
RAT_KERNELS = ("step", "riccati_folded")           # phase 7's path
MODEL_DIMS = {"unicycle": (3, 2), "quadrotor": (12, 4), "cartpole": (4, 1)}
# The cartpole cells (PERF.md §4): cold from a start that does real work;
# JAX's own bench cell (benchmarks/run_all.py:283-301) starts at the
# fixed point x0 = 0, where every θ > 0 lane fails at iteration 0.
CART_T = 50
CART_X0 = (0.3, 0.0, 0.4, 0.0)
CART_THETA_MAX = 0.05
# Any problem: kernels A and D at a shape outside the shipped library.
LINEAR = "linear6x3"
LINEAR_T = 20
B_LINEAR = 4_099
LINEAR_CONFIGS = {   # name: (config, the kernels its path must run)
    "default": (ILEQGConfig(), ("riccati",)),
    "fused flags": (ILEQGConfig(fused_step_optimize=True,
                                fused_candidate_eval=True),
                    ("riccati", "riccati_folded")),
    "fold": (ILEQGConfig(fold_candidate_eval=True),
             ("riccati", "riccati_folded")),
}


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--id=0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def build():
    """Phase 2: build the kernels; prints each source's nvcc time and each
    kernel's ptxas report, the team kernels' with their shared memory a
    block, then the same for kernels A at (6, 3) and D at n=6, built for
    those shapes alone."""
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {lib_path.name} "
          f"({lib_path.parent.name})", flush=True)
    for line in _build.report(lib_path):
        print("  " + line, flush=True)
    rows = _build.ptxas_report((lib_path.parent / "build.log").read_text())
    for dtype, name in ((torch.float32, "float"), (torch.float64, "double")):
        entry = "riccati_team_kernel"
        for fn, regs, stores, loads, stack in rows:   # demangled or not
            if f"{entry}<{name}," in fn or f"{entry}I{name[0]}" in fn:
                print(f"kernel A, one solve per team ((12, 4), {dtype}) "
                      f"{_build.short_name(fn)}: {regs} registers, {stack} B "
                      f"stack frame, {stores} B spill stores", flush=True)
        smem = {(opt, w): riccati_cuda.block_shared_memory(12, 4, dtype, opt,
                                                            w)
                for opt in (True, False) for w in (True, False)}
        print(f"kernel A, one solve per team ((12, 4), {dtype}): dynamic "
              "shared memory a block of {1} teams of {2} lanes: ".format(
                  *smem[True, True])
              + ", ".join(f"{'optimizing' if opt else 'evaluating'} "
                          f"{'shared' if w else 'per-lane'} W {v[0]} B"
                          for (opt, w), v in smem.items()), flush=True)
        entry = "riccati_folded_team_kernel"
        for fn, regs, stores, loads, stack in rows:   # demangled or not
            if f"{entry}<{name}," in fn or f"{entry}I{name[0]}" in fn:
                print(f"kernel D, one solve per team (n=12, {dtype}) "
                      f"{_build.short_name(fn)}: {regs} registers, {stack} B "
                      f"stack frame, {stores} B spill stores", flush=True)
        smem = {w: riccati_cuda.folded_block_shared_memory(12, dtype, w)
                for w in (True, False)}
        print(f"kernel D, one solve per team (n=12, {dtype}): dynamic "
              "shared memory a block of {1} teams of {2} lanes: ".format(
                  *smem[True])
              + ", ".join(f"{'shared' if w else 'per-lane'} W {v[0]} B"
                          for w, v in smem.items()), flush=True)
    for label, kernel in (("B", "step"), ("C", "candidate")):
        for dtype, name in ((torch.float32, "float"),
                            (torch.float64, "double")):
            nbytes, teams, lanes = _build.block_shared_memory(
                kernel, tile_model.QUADROTOR, dtype, B_MAIN)
            entry = f"{kernel}_team_kernel"
            for fn, regs, stores, loads, stack in rows:   # demangled or not
                if f"{entry}<{name}," in fn or f"{entry}I{name[0]}" in fn:
                    print(f"kernel {label}, one solve per team (quadrotor, "
                          f"{dtype}): {regs} registers, {stack} B stack "
                          f"frame, {stores} B spill stores, {nbytes} B "
                          f"dynamic shared memory a block of {teams} teams "
                          f"of {lanes} lanes", flush=True)
    small_report(rows)
    units = [(kernel, shape, suffix)
             for kernel, shape in (("riccati", (6, 3)),
                                   ("riccati_folded", (6,)))
             for suffix in ("f32", "f64")]
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(units)) as pool:
        libs = list(pool.map(lambda u: _build.build_shape(*u), units))
    for unit in units:
        _build.shape_library(*unit)
    print(f"build at first use: {time.perf_counter() - t0:.1f} s for A at "
          "(6, 3) and D at n=6, f32 and f64, in parallel", flush=True)
    for lib in {lib.parent: lib for lib in libs}.values():   # one log each
        for line in _build.report(lib):
            print("  " + line, flush=True)


# Kernels B's and C's models at n <= 4 and the horizons phase 3 checks
# them at.
SMALL_C_MODELS = {"unicycle": (tile_model.UNICYCLE, FLEET_T),
                  "lqr": (tile_model.LQR, 7),
                  "cartpole": (tile_model.CARTPOLE, CART_T)}
# Kernels B's and C's few-lane designs: (label, kernel, wrapper module).
SMALL_KERNELS = (("B", "step", step_cuda), ("C", "candidate", candidate_cuda))
# The near-breakdown fixture on which kernels B's and C's float32 fail
# flags disagreed with the plain version's before the contraction policy
# (csrc/smallmat.cuh): (model, horizon, width).
FLAG_CASE = ("cartpole", 20, 33_793)
RAT_WIDTH = RAT_CONFIG.num_samples   # RAT iLQR's banks (kernel B, T=100)


def one_lane_widths(module, dtype):
    """{model: the first width at which kernel B's or C's launch (the
    wrapper ``module``'s) at n <= 4 takes one lane a solve on this card},
    from the launch's own query."""
    return {model: module.first_widths(model_id, dtype)[1]
            for model, (model_id, _) in SMALL_C_MODELS.items()}


def small_report(rows):
    """Phase 2: kernels B's and C's few-lane kernels (n <= 4): each
    instantiation's ptxas report, and the lanes a solve, solves a block and
    shared memory the launch takes at the widths of this script."""
    for label, kernel, module in SMALL_KERNELS:
        for fn, regs, stores, loads, stack in rows:
            if f"{kernel}_kernel" in fn:   # not the team kernel
                print(f"kernel {label}, few lanes a solve (n <= 4) "
                      f"{_build.short_name(fn)}: {regs} registers, {stack} B "
                      f"stack frame, {stores} B spill stores, {loads} B "
                      "spill loads", flush=True)
        for dtype in (torch.float32, torch.float64):
            for model, (model_id, _) in SMALL_C_MODELS.items():
                shapes = []
                for B in sorted({1, 5, RAT_WIDTH, 942, *FLEET_WIDTHS, 4_099,
                                 B_MAIN, *module.first_widths(
                                     model_id, dtype).values(), B_WIDE}):
                    nbytes, solves, lanes = module.block_shared_memory(
                        model_id, dtype, B)
                    shapes.append(f"B={B}: K={lanes}, {solves} solves, "
                                  f"{nbytes} B")
                print(f"kernel {label}, few lanes a solve ({model}, {dtype}),"
                      " launch by width (lanes a solve, solves a block, "
                      "shared memory a block): " + "; ".join(shapes),
                      flush=True)


def check_kernels(device):
    """Phase 3: returns the largest float32 difference per kernel."""
    err32 = {}
    cases = [("unicycle", T), ("lqr", 7), ("quadrotor", QUAD_T),
             ("cartpole", CART_T)]
    for dtype in (torch.float32, torch.float64):
        worst = {name: (0.0, 0.0) for name in KERNELS}

        def keep(name, result):
            worst[name] = tuple(map(max, worst[name], result))

        for B in (1, 5, 4_099):
            for model, horizon in cases + [(LINEAR, LINEAR_T),
                                           (kernel_check.H_FAIL, QUAD_T)]:
                for variant in kernel_check.RICCATI_VARIANTS:
                    keep("riccati", kernel_check.check_riccati(
                        model, horizon, B, dtype, device, **variant))
                kernel_check.clear_caches()
            for model, horizon in cases + [(LINEAR, LINEAR_T)]:
                for shared_w in (True, False):
                    keep("riccati_folded", kernel_check.check_riccati_folded(
                        model, horizon, B, dtype, device, shared_w))
            for model, horizon in cases:
                keep("candidate", kernel_check.check_candidate(
                    model, horizon, B, dtype, device))
            for model, horizon in cases + [
                    ("negative_curvature", 7), (kernel_check.H_FAIL, QUAD_T),
                    (kernel_check.h_fail_fixture("cartpole"), CART_T)]:
                keep("step", kernel_check.check_step(model, horizon, B, dtype,
                                                     device))
        for B in FLEET_WIDTHS:   # the fleets' path: kernels A and C
            for variant in kernel_check.RICCATI_VARIANTS:
                keep("riccati", kernel_check.check_riccati(
                    "unicycle", FLEET_T, B, dtype, device, **variant))
            keep("candidate", kernel_check.check_candidate(
                "unicycle", FLEET_T, B, dtype, device))
            kernel_check.clear_caches()
        # Kernels B and C at n <= 4 take 4 lanes a solve at every width
        # above; these are the first at which their launch takes 1.
        one_lane = one_lane_widths(candidate_cuda, dtype)
        for model, (model_id, horizon) in SMALL_C_MODELS.items():
            keep("candidate", kernel_check.check_candidate(
                model, horizon, one_lane[model], dtype, device))
        one_lane_b = one_lane_widths(step_cuda, dtype)
        for model, (model_id, horizon) in SMALL_C_MODELS.items():
            keep("step", kernel_check.check_step(
                model, horizon, one_lane_b[model], dtype, device))
        torch.cuda.empty_cache()
        f32 = dtype == torch.float32
        if f32:
            keep("riccati", kernel_check.check_riccati_wide(
                "quadrotor", QUAD_T, B_WIDE, dtype, device))
            kernel_check.clear_caches()
            torch.cuda.empty_cache()
            for shared_w in (True, False):
                keep("riccati_folded", kernel_check.check_riccati_folded_wide(
                    "quadrotor", QUAD_T, B_WIDE, dtype, device, shared_w))
                torch.cuda.empty_cache()
        print(f"kernels vs plain, {dtype}, unicycle T=100, LQR T=7, "
              f"quadrotor T={QUAD_T}, cartpole T={CART_T} (A-D), "
              f"{LINEAR} T={LINEAR_T} (A, D) and the h_fail fixture (A, B), "
              f"B=1, B=5 and B=4099; the unicycle T={FLEET_T} at the "
              f"fleets' widths B={FLEET_WIDTHS[0]} and B={FLEET_WIDTHS[1]} "
              f"(A, C); C on the unicycle, LQR and the cartpole at "
              f"B={', '.join(map(str, one_lane.values()))} and B at "
              f"B={', '.join(map(str, one_lane_b.values()))} (the first "
              f"widths taking 1 lane a solve)"
              + (f", A's slim optimizing pass and D (shared and per-lane W)"
                 f" on the quadrotor at B={B_WIDE}" if f32 else "") + ", "
              f"{len(kernel_check.RICCATI_VARIANTS)} riccati variants: agree; "
              "max |kernel - plain|"
              + (" (plain's own error vs float64)" if f32 else "") + ": "
              + ", ".join(f"{k} {e:.3e}" + (f" ({p:.3e})" if f32 else "")
                          for k, (e, p) in worst.items()), flush=True)
        if f32:
            err32 = {k: e for k, (e, _) in worst.items()}
    for model, horizon in (("unicycle", T), ("quadrotor", QUAD_T),
                           ("cartpole", CART_T)):
        m_fail, _ = kernel_check.expect_fail_pattern(model, horizon, 4_099,
                                                     torch.float32, device)
        expect = int(np.sum(np.resize(kernel_check.THETA_MIX, 4_099) == 1e6))
        assert m_fail == expect, (f"{model}: {m_fail} m_fail lanes, "
                                  f"expected {expect}")
        print(f"fail latching, {model}: {m_fail} θ=1e6 lanes of 4099 latch "
              "m_fail in kernel B", flush=True)
    _, h_fail = kernel_check.expect_fail_pattern("negative_curvature", 7, 5,
                                                 torch.float32, device)
    assert h_fail > 0, "the negative-curvature fixture must fail H"
    print(f"fail latching: {h_fail}/5 negative-curvature lanes latch h_fail",
          flush=True)
    m_fail, h_fail = kernel_check.expect_fail_pattern(
        kernel_check.H_FAIL, QUAD_T, 4_099, torch.float32, device)
    mus = np.resize(kernel_check.H_FAIL_MU_MIX, 4_099)
    expect = (int(np.sum(np.resize(kernel_check.THETA_MIX, 4_099) == 1e6)),
              int(np.sum(mus == kernel_check.H_FAIL_MU)))
    assert (m_fail, h_fail) == expect, (
        f"n=12 h_fail fixture: (m_fail, h_fail) lanes {(m_fail, h_fail)}, "
        f"expected {expect}")
    print(f"fail latching, quadrotor (n=12) h_fail fixture: {h_fail} μ=-1e6 "
          f"lanes of 4099 latch h_fail and {m_fail} θ=1e6 lanes m_fail in "
          "kernel B", flush=True)
    m_fail, h_fail = kernel_check.expect_fail_pattern(
        kernel_check.H_FAIL, QUAD_T, 4_099, torch.float32, device,
        kernel="riccati")
    kernel_check.clear_caches()
    assert (m_fail, h_fail) == expect, (
        f"n=12 h_fail fixture, kernel A: (m_fail, h_fail) lanes "
        f"{(m_fail, h_fail)}, expected {expect}")
    print(f"fail latching, quadrotor (n=12) h_fail fixture: {h_fail} μ=-1e6 "
          f"lanes of 4099 latch h_fail and {m_fail} θ=1e6 lanes m_fail in "
          "kernel A", flush=True)
    model, horizon, B = FLAG_CASE
    errs = {label: kernel_check.check_candidate(*FLAG_CASE, torch.float32,
                                                device)
            if kernel == "candidate" else
            kernel_check.check_step(*FLAG_CASE, torch.float32, device)
            for label, kernel, _ in SMALL_KERNELS}
    print(f"fail flags, near-breakdown fixture ({model} T={horizon} B={B} "
          "float32, 1 lane a solve): kernel B's m_fail and h_fail and kernel "
          "C's m_fail equal the plain version's on every lane; max |kernel "
          "- plain| (plain's own error vs float64): " + ", ".join(
              f"{label} {e:.3e} ({p:.3e})" for label, (e, p) in errs.items()),
          flush=True)
    return err32


def check_result(name, res, B, horizon, m, secs):
    assert res.value.shape == (B,) and res.l.shape == (B, horizon, m)
    n_failed = int(res.failed.sum())
    assert n_failed == 0, f"{name} B={B}: {n_failed} failed lanes"
    assert bool(torch.isfinite(res.value).all()), f"{name} B={B}"
    it = res.iterations
    print(f"{name} B={B}: 0 failed, values "
          f"{float(res.value.min()):.6f}..{float(res.value.max()):.6f}, "
          f"iterations {int(it.min())}..{int(it.max())}, {secs:.3f} s, "
          f"{B / secs:.1f} solves/s (host clock)", flush=True)


def main_path(device):
    """Phase 4: the unicycle bank at full width; returns (cold result,
    launch counts)."""
    f32 = torch.float32
    prob = unicycle(N=T, dtype=f32, device=device)
    bank = make_batched_solver(prob, BENCH_CONFIG, device=device)
    x0 = torch.zeros(3, dtype=f32, device=device)
    x_mpc = x0 + torch.tensor(X_MPC, dtype=f32, device=device)
    thetas = torch.linspace(0.0, 0.02, B_MAIN, dtype=f32, device=device)
    thetas_wide = torch.linspace(0.0, 0.02, B_WIDE, dtype=f32, device=device)

    _build.reset_launch_counts()
    cold, t_cold = sync_time(lambda: bank(
        x0, torch.zeros((T, 2), dtype=f32, device=device), thetas))
    u_warm = cold.l[0]
    warm, t_warm = sync_time(lambda: bank(x_mpc, u_warm, thetas))
    wide, t_wide = sync_time(lambda: bank(x_mpc, u_warm, thetas_wide))
    default_bank = make_batched_solver(prob, ILEQGConfig(iter_max=3),
                                       device=device)
    dflt, t_dflt = sync_time(lambda: default_bank(
        x_mpc, u_warm, thetas[:: B_MAIN // B_DEFAULT]))
    counts = dict(_build.launch_counts)

    for name, res, B, secs in (("cold", cold, B_MAIN, t_cold),
                               ("warm", warm, B_MAIN, t_warm),
                               ("warm", wide, B_WIDE, t_wide),
                               ("default-config warm", dflt, B_DEFAULT,
                                t_dflt)):
        check_result(f"unicycle bank {name} solve", res, B, T, 2, secs)
    for name in BANK_KERNELS:
        assert counts.get(name, 0) > 0, f"{name} kernel never launched"
    print(f"unicycle bank path launch counts: {counts}", flush=True)
    return cold, counts


def lane_idx(B: int, n: int = 64) -> torch.Tensor:
    """``n`` lanes spread over a bank of ``B``."""
    return torch.linspace(0, B - 1, n).round().long()


def lanes(res, idx=None) -> dict:
    """A bank result's ``failed``, ``iterations`` and ``value`` (at
    ``idx``) on the CPU."""
    return {k: (getattr(res, k) if idx is None else
                getattr(res, k)[idx.to(res.value.device)]).cpu()
            for k in ("failed", "iterations", "value")}


# The CPU halves of the card-vs-CPU checks.  They depend on nothing the
# card computes, so they run in worker processes (CPU_WORKERS, each on
# CPU_THREADS threads) while the card runs the phases before them.
CPU_WORKERS = 2
CPU_THREADS = 3


def timed(fn):
    """``(fn(), seconds, finished at)`` (the end on the wall clock, which
    the worker and the main process share)."""
    t0 = time.time()
    out = fn()
    return out, time.time() - t0, time.time()


def cpu_unicycle():
    """Phase 5's CPU half: 64 lanes of the cold B=16,384 bank, plain."""
    thetas = torch.linspace(0.0, 0.02, B_MAIN,
                            dtype=torch.float32)[lane_idx(B_MAIN)]
    bank = make_batched_solver(unicycle(N=T, dtype=torch.float32,
                                        device="cpu"),
                               BENCH_CONFIG)
    return lanes(bank(torch.zeros(3), torch.zeros((T, 2)), thetas))


def plain_cpu_parity(cold, job):
    """Phase 5: 64 lanes of the cold B=16,384 bank on the CPU, plain."""
    res = job.result()[0]
    gpu = lanes(cold, lane_idx(B_MAIN))
    assert torch.equal(res["failed"], gpu["failed"]), "failed lanes differ"
    assert torch.equal(res["iterations"], gpu["iterations"]), (
        f"iterations differ: cpu {res['iterations'].tolist()} "
        f"gpu {gpu['iterations'].tolist()}")
    torch.testing.assert_close(gpu["value"], res["value"], rtol=1e-3,
                               atol=0)
    rel = float(((gpu["value"] - res["value"]) / res["value"]).abs().max())
    print(f"64 lanes vs the plain path on the CPU (f32): failed and "
          f"iterations equal, value max rel diff {rel:.3e}", flush=True)


def quad_thetas(B, dtype=torch.float32, device=None):
    return torch.linspace(0.0, QUAD_THETA_MAX, B, dtype=dtype,
                          device=device)


def expect_path(name, launched, path):
    """Fail unless exactly the kernels of ``path`` were launched."""
    for kernel in KERNELS:
        ran = launched.get(kernel, 0)
        assert (ran > 0) == (kernel in path), (
            f"{name}: launches {launched}, expected exactly {path}")


def run_bank(name, prob, key, device, x0, u_init, thetas, counts):
    """One bank solve of configuration ``key`` of ``MODEL_CONFIGS``, with
    the launch counts read around it, checked against the configuration's
    path and added to ``counts[key]``; 0 failed lanes."""
    config, path = MODEL_CONFIGS[key]
    bank = make_batched_solver(prob, config, device=device)
    torch.cuda.empty_cache()
    _build.reset_launch_counts()
    res, secs = sync_time(lambda: bank(x0, u_init, thetas))
    launched = dict(_build.launch_counts)
    B, horizon, m = res.l.shape
    check_result(name, res, B, horizon, m, secs)
    expect_path(f"{name} B={B}", launched, path)
    print(f"{name} B={B} launch counts: {launched}", flush=True)
    for kernel, n in launched.items():
        counts.setdefault(key, {})
        counts[key][kernel] = counts[key].get(kernel, 0) + n
    return res


def quadrotor_path(device):
    """Phase 6: the model-size bank path on the quadrotor; returns the
    launch counts per configuration."""
    f32 = torch.float32
    prob = quadrotor(N=QUAD_T, dtype=f32, device=device)
    x0 = torch.zeros(12, dtype=f32, device=device)
    u0 = torch.zeros((QUAD_T, 4), dtype=f32, device=device)
    counts, u_warm = {}, {}

    def run(key, label, B, u_init):
        return run_bank(f"quadrotor ({key}) {label} solve", prob, key, device,
                        x0, u_init, quad_thetas(B), counts)

    for key in ("a", "b"):
        cold = run(key, "cold", B_MAIN, u0)
        u_warm[key] = cold.l[0]
        del cold
        run(key, "warm", B_MAIN, u_warm[key])
    run("b", "warm", B_WIDE, u_warm["b"])
    run("c", "warm", B_MAIN, u_warm["b"])
    print(f"quadrotor path launch counts: {counts}", flush=True)
    return counts


def quad64(device):
    """Configuration (b) at 64 θ, cold, in float64 on ``device``."""
    f64 = torch.float64
    bank = make_batched_solver(quadrotor(N=QUAD_T, dtype=f64, device=device),
                               MODEL_CONFIGS["b"][0], device=device)
    return lanes(bank(torch.zeros(12, dtype=f64),
                      torch.zeros((QUAD_T, 4), dtype=f64),
                      quad_thetas(B_MAIN, f64)[lane_idx(B_MAIN)]))


def cpu_quadrotor():
    return quad64(torch.device("cpu"))


def quadrotor_cpu_parity(device, job):
    """Phase 6, last: 64 θ of configuration (b), cold, in float64 on the
    card and on the CPU through the plain path."""
    gpu, cpu = quad64(device), job.result()[0]
    assert not bool(cpu["failed"].any()), "float64 quadrotor lanes failed"
    assert torch.equal(cpu["failed"], gpu["failed"]), "failed lanes differ"
    assert torch.equal(cpu["iterations"], gpu["iterations"]), (
        f"iterations differ: cpu {cpu['iterations'].tolist()} "
        f"gpu {gpu['iterations'].tolist()}")
    torch.testing.assert_close(gpu["value"], cpu["value"], rtol=1e-3,
                               atol=0)
    rel = float(((gpu["value"] - cpu["value"]) / cpu["value"]).abs().max())
    it = cpu["iterations"]
    print(f"64 quadrotor θ of (b) in float64 on the card vs the plain path "
          f"on the CPU: failed and iterations ({int(it.min())}.."
          f"{int(it.max())}) equal, value max rel diff {rel:.3e}",
          flush=True)


def cart_thetas(B, dtype=torch.float32, device=None):
    return torch.linspace(0.0, CART_THETA_MAX, B, dtype=dtype, device=device)


def cartpole_path(device):
    """Phase 6, the cartpole: the working cell cold in (a), (b) and (c) at
    B=16,384 and (b) at B=262,144; returns the launch counts per
    configuration."""
    f32 = torch.float32
    prob = cartpole(N=CART_T, dtype=f32, device=device)
    x0 = torch.tensor(CART_X0, dtype=f32, device=device)
    u0 = torch.zeros((CART_T, 1), dtype=f32, device=device)
    counts = {}
    for key, B in (("a", B_MAIN), ("b", B_MAIN), ("c", B_MAIN),
                   ("b", B_WIDE)):
        run_bank(f"cartpole ({key}) cold solve", prob, key, device, x0, u0,
                 cart_thetas(B, device=device), counts)
    print(f"cartpole path launch counts: {counts}", flush=True)
    return counts


def cart64(device):
    """The working cell (b) at 64 θ, cold, in float64 on ``device``."""
    f64 = torch.float64
    bank = make_batched_solver(cartpole(N=CART_T, dtype=f64, device=device),
                               MODEL_CONFIGS["b"][0])
    return lanes(bank(torch.tensor(CART_X0, dtype=f64),
                      torch.zeros((CART_T, 1), dtype=f64),
                      cart_thetas(B_MAIN, f64)[lane_idx(B_MAIN)]))


def cpu_cartpole():
    """The cartpole's CPU halves: JAX's bench cell (x0 = 0, (a), f32) and
    the working cell (b) in float64, 64 lanes each, plain."""
    f32 = torch.float32
    bank = make_batched_solver(cartpole(N=CART_T, dtype=f32, device="cpu"),
                               MODEL_CONFIGS["a"][0])
    zero = bank(torch.zeros(4, dtype=f32), torch.zeros((CART_T, 1)),
                cart_thetas(B_MAIN, f32)[lane_idx(B_MAIN)])
    return lanes(zero), cart64(torch.device("cpu"))


def cartpole_cpu_parity(device, job):
    """Phase 6, the cartpole against the CPU's plain path: JAX's bench cell
    (x0 = 0, configuration (a), cold and warm at B=16,384; its failure
    pattern on 64 lanes), then 64 lanes of the working cell (b) in
    float64."""
    f32 = torch.float32
    idx = lane_idx(B_MAIN)
    thetas = cart_thetas(B_MAIN, f32, device)
    zero_x, zero_u = torch.zeros(4, dtype=f32), torch.zeros((CART_T, 1))
    bank = make_batched_solver(cartpole(N=CART_T, dtype=f32, device=device),
                               MODEL_CONFIGS["a"][0])
    cold = bank(zero_x, zero_u, thetas)
    warm = bank(zero_x, cold.l[0], thetas)
    positive = thetas > 0
    for label, res in (("cold", cold), ("warm", warm)):
        n_failed = int(res.failed.sum())
        at_zero = bool((res.iterations[res.failed] == 0).all())
        print(f"cartpole JAX bench cell (x0 = 0, (a)) {label} B={B_MAIN}: "
              f"{n_failed} failed lanes of {int(positive.sum())} with θ > 0"
              f", all at iteration 0: {at_zero}", flush=True)
    plain, cpu_res = job.result()[0]
    got = lanes(cold, idx)
    for k in ("failed", "iterations"):
        assert torch.equal(got[k], plain[k]), (
            f"x0 = 0 {k} differ: cpu {plain[k].tolist()} gpu "
            f"{got[k].tolist()}")
    print(f"cartpole x0 = 0: 64 lanes' failed ({int(plain['failed'].sum())})"
          " and iterations equal to the CPU plain path's", flush=True)

    gpu = cart64(device)
    assert not bool(cpu_res["failed"].any()), "float64 cartpole lanes failed"
    assert torch.equal(cpu_res["failed"], gpu["failed"]), (
        "failed lanes differ")
    assert torch.equal(cpu_res["iterations"], gpu["iterations"]), (
        f"iterations differ: cpu {cpu_res['iterations'].tolist()} "
        f"gpu {gpu['iterations'].tolist()}")
    torch.testing.assert_close(gpu["value"], cpu_res["value"], rtol=1e-9,
                               atol=0)
    rel = float(((gpu["value"] - cpu_res["value"])
                 / cpu_res["value"]).abs().max())
    it = cpu_res["iterations"]
    print(f"64 cartpole θ of (b) in float64 on the card vs the plain path on "
          f"the CPU: failed and iterations ({int(it.min())}..{int(it.max())})"
          f" equal, value max rel diff {rel:.3e}", flush=True)


def linear_inputs():
    n, m = kernel_check.linear_dims(LINEAR)
    x0 = np.random.default_rng(0).uniform(-1.0, 1.0, n)
    return (x0, np.zeros((LINEAR_T, m)), np.linspace(0.0, 0.05, B_LINEAR),
            np.linspace(0, B_LINEAR - 1, 64).round().astype(int))


def cpu_linear():
    """Phase 6b's CPU half: 64 lanes in each configuration, plain."""
    x0, u0, thetas, idx = linear_inputs()
    prob = kernel_check.make_problem(LINEAR, LINEAR_T, torch.float64,
                                     torch.device("cpu"))
    return {name: lanes(make_batched_solver(prob, config)(x0, u0,
                                                          thetas[idx]))
            for name, (config, _) in LINEAR_CONFIGS.items()}


def linear_path(device, job):
    """Phase 6b: the random linear problem at (6, 3), no tile model, on the
    card in each configuration of ``LINEAR_CONFIGS``, 64 lanes against the
    CPU's plain path in float64; then one bank from numpy inputs.  Returns
    the launch counts per configuration."""
    m = kernel_check.linear_dims(LINEAR)[1]
    x0, u0, thetas, idx = linear_inputs()
    prob = kernel_check.make_problem(LINEAR, LINEAR_T, torch.float64, device)
    counts = {}
    for name, (config, path) in LINEAR_CONFIGS.items():
        _build.reset_launch_counts()
        res, secs = sync_time(lambda: make_batched_solver(prob, config)(
            torch.tensor(x0), torch.tensor(u0), torch.tensor(thetas)))
        counts[name] = dict(_build.launch_counts)
        check_result(f"{LINEAR} ({name}) f64 solve", res, B_LINEAR, LINEAR_T,
                     m, secs)
        expect_path(f"{LINEAR} ({name})", counts[name], path)
        plain, got = job.result()[0][name], lanes(res, torch.tensor(idx))
        for k in ("failed", "iterations"):
            assert torch.equal(got[k], plain[k]), f"{name}: {k} differ"
        torch.testing.assert_close(got["value"], plain["value"], rtol=1e-9,
                                   atol=0)
        rel = float(((got["value"] - plain["value"])
                     / plain["value"]).abs().max())
        print(f"{LINEAR} ({name}): launch counts {counts[name]}; 64 lanes "
              f"equal to the CPU plain path's, value max rel diff {rel:.3e}",
              flush=True)
    _build.reset_launch_counts()
    res = make_batched_solver(prob, ILEQGConfig())(x0, u0, thetas)
    launched = dict(_build.launch_counts)
    assert res.value.device.type == "cuda" and res.l.device.type == "cuda"
    assert launched.get("riccati", 0) > 0, launched
    print(f"{LINEAR} from numpy inputs on a problem on the card: result on "
          f"{res.value.device}, launch counts {launched}", flush=True)
    return counts


def rat_problem(device, dtype=torch.float32):
    return unicycle(N=T, noise=2e-3, dtype=dtype, device=device,
                    analytic_jacobians=True)


def rat_mpc(device):
    """Phase 7: N_REPLANS[entry] MPC re-plans through each RAT iLQR entry
    point;
    returns the launch counts of the path."""
    f32 = torch.float32
    prob = rat_problem(device)
    solver = RATiLQRSolver(prob, RAT_CONFIG)
    single = {"state": ratilqr.init_state(RAT_CONFIG, f32)}

    def plan_single(x, u, gen):
        res = ratilqr_jit.solve(prob, RAT_CONFIG, single["state"], x, u, gen,
                                KL_BOUND)
        single["state"] = res.state
        return res

    plans = {"ratilqr": lambda x, u, gen: solver.solve(x, u, gen,
                                                       kl_bound=KL_BOUND),
             "ratilqr_jit": plan_single}
    total = {}
    for name, plan in plans.items():
        records = []

        def counted(x, u, gen, plan=plan, records=records):
            before = dict(_build.launch_counts)
            with count_host_syncs() as syncs:
                res = plan(x, u, gen)
            records.append((res, syncs.n, {
                k: _build.launch_counts[k] - before.get(k, 0)
                for k in RAT_KERNELS}))
            return res

        _build.reset_launch_counts()
        steps = MPCDriver(prob, counted).run(
            torch.zeros(3, dtype=f32, device=device),
            torch.zeros((T, 2), dtype=f32, device=device),
            torch.Generator().manual_seed(0), N_REPLANS[name])
        counts = dict(_build.launch_counts)
        for k, (step, (res, syncs, launches)) in enumerate(
                zip(steps, records)):
            assert bool(torch.isfinite(step.value)) and bool(
                torch.isfinite(step.u).all()), f"{name} re-plan {k}"
            assert float(res.theta_opt) > 0, f"{name} re-plan {k}: θ_opt 0"
            assert not res.final_failed, f"{name} re-plan {k} failed"
            print(f"RAT iLQR {name} re-plan {k}: θ_opt "
                  f"{float(res.theta_opt):.6g}, value "
                  f"{float(step.value):.6f}, plan "
                  f"{step.plan_time_s * 1e3:.1f} ms, {syncs} host syncs, "
                  f"launches step {launches['step']} riccati_folded "
                  f"{launches['riccati_folded']}"
                  + (", redraws exhausted" if res.redraws_exhausted else ""),
                  flush=True)
        lat = sorted(s.plan_time_s for s in steps[1:])
        warm = (f"warm re-plan p50 {lat[len(lat) // 2] * 1e3:.1f} ms over "
                f"re-plans 1-{N_REPLANS[name] - 1}, " if lat else "")
        print(f"RAT iLQR {name}: {warm}cold "
              f"{steps[0].plan_time_s * 1e3:.1f} ms (host clock, device "
              f"synchronized); "
              f"launch counts {counts}", flush=True)
        for kernel in RAT_KERNELS:
            assert counts.get(kernel, 0) > 0, f"{name}: {kernel} never ran"
        for kernel, n in counts.items():
            total[kernel] = total.get(kernel, 0) + n
    return total


def nm_config(refresh: bool, depth: int) -> NelderMeadConfig:
    return NelderMeadConfig(theta_high_init=0.02, theta_low_init=1e-8,
                            refresh_carried_costs=refresh,
                            speculation_depth=depth, ileqg=NM_INNER)


def widths_text(widths) -> str:
    """Bank widths in run order, runs of one width folded: "120, 942 x 2"."""
    return ", ".join(f"{w}" + (f" x {n}" if n > 1 else "") for w, n in (
        (w, len(list(g))) for w, g in itertools.groupby(widths)))


def nm_mpc(device):
    """Phase 7b: MPC re-plans through each entry point of ``NM_PATHS``
    (their number is the path's), each re-plan's banks, host syncs and
    launches read
    around it; then whether the single-call path's carried final lane
    equals a fresh one-lane solve.  Returns the launch counts per path."""
    f32 = torch.float32
    prob = unicycle(N=NM_T, dtype=f32, device=device)
    x0 = torch.zeros(3, dtype=f32, device=device)
    u0 = torch.zeros((NM_T, 2), dtype=f32, device=device)
    counts = {}
    for name, (solve, refresh, depth, replans) in NM_PATHS.items():
        config = nm_config(refresh, depth)
        state = {"s": nelder_mead.init_state(config)}
        records = []

        def counted(x, u, kl_bound, solve=solve, config=config,
                    state=state, records=records):
            before = dict(_build.launch_counts)
            with count_host_syncs() as syncs, \
                    ileqg.record_banks() as widths:
                res = solve(prob, config, state["s"], x, u,
                            kl_bound=kl_bound)
            state["s"] = res.state
            records.append((res, syncs.n, list(widths), {
                k: _build.launch_counts[k] - before.get(k, 0)
                for k in NM_KERNELS}))
            return res

        _build.reset_launch_counts()
        steps = MPCDriver(prob, plan_without_generator(
            counted, kl_bound=NM_KL)).run(
                x0, u0, torch.Generator().manual_seed(0), replans)
        counts[name] = dict(_build.launch_counts)
        for k, (step, (res, syncs, widths, launches)) in enumerate(
                zip(steps, records)):
            assert bool(torch.isfinite(step.value)) and bool(
                torch.isfinite(step.u).all()), f"{name} re-plan {k}"
            assert float(res.theta_opt) > 0, f"{name} re-plan {k}: θ_opt 0"
            print(f"RAT iLQR++ {name} re-plan {k}: θ_opt "
                  f"{float(res.theta_opt):.6g}, value "
                  f"{float(step.value):.6f}, {res.state.iter_current} NM "
                  f"iterations, {len(widths)} banks ({widths_text(widths)}),"
                  f" {syncs} host syncs, launches riccati "
                  f"{launches['riccati']} candidate {launches['candidate']},"
                  f" plan {step.plan_time_s * 1e3:.1f} ms", flush=True)
        lat = sorted(s.plan_time_s for s in steps[1:])
        warm = (f"warm re-plan p50 {lat[len(lat) // 2] * 1e3:.1f} ms over "
                f"re-plans 1-{replans - 1}, " if lat else "")
        print(f"RAT iLQR++ {name}: {warm}cold "
              f"{steps[0].plan_time_s * 1e3:.1f} ms (host clock, device "
              f"synchronized); launch counts {counts[name]}", flush=True)
        expect_path(name, counts[name], NM_KERNELS)
        if solve is nelder_mead_jit.solve:
            # The cold re-plan's result is θ_low's carried lane: does a
            # fresh one-lane solve at θ_opt give the same, bit for bit?
            res = records[0][0]
            fresh = solve_one(nelder_mead.vertex_bank(prob, config.ileqg),
                              x0, u0, float(res.theta_opt))
            value = fresh.value + float(torch.tensor(NM_KL, dtype=f32)
                                        / res.theta_opt)
            exact = all(torch.equal(a, b) for a, b in (
                (res.x, fresh.x), (res.l, fresh.l), (res.L, fresh.L),
                (res.value, value)))
            print(f"RAT iLQR++ {name}, f32: the cold re-plan's carried lane "
                  f"against a fresh one-lane solve at θ_opt: x, l, L, value "
                  f"bit for bit equal: {exact}; max |Δl| "
                  f"{float((res.l - fresh.l).abs().max()):.3e}, |Δvalue| "
                  f"{abs(float(res.value - value)):.3e}", flush=True)
    return counts


def nm_cold64(device) -> dict:
    """One cold RAT iLQR++ solve in float64 on ``device`` through the host
    path (reference semantics) and the single-call path at depth 3: label
    -> (θ_opt, value, state, seconds).  The unicycle with closed-form
    Jacobians keeps the CPU runs short."""
    f64 = torch.float64
    prob = unicycle(N=NM_T, dtype=f64, device=device, analytic_jacobians=True)
    out = {}
    for label, solve, depth in (("host", nelder_mead.solve, 1),
                                ("single-call d3", nelder_mead_jit.solve, 3)):
        config = nm_config(False, depth)
        t0 = time.perf_counter()
        res = solve(prob, config, nelder_mead.init_state(config),
                    torch.zeros(3, dtype=f64),
                    torch.zeros((NM_T, 2), dtype=f64), kl_bound=NM_KL)
        out[label] = (float(res.theta_opt), float(res.value), res.state,
                      time.perf_counter() - t0)
    return out


def cpu_nm():
    return nm_cold64(torch.device("cpu"))


def nm_f64_parity(device, job):
    """Phase 7b, last: one cold solve in float64 through the host path
    (reference semantics) and the single-call path at depth 3, on the card
    and on the CPU: every run must take the same decisions."""
    runs = {("cuda", label): r for label, r in nm_cold64(device).items()}
    runs.update({("cpu", label): r for label, r in job.result()[0].items()})
    ref_theta, _, sr, _ = runs[("cpu", "host")]
    for (dev, label), (theta, value, st, secs) in runs.items():
        assert st.iter_current == sr.iter_current, (
            f"{dev} {label}: {st.iter_current} NM iterations, the CPU host "
            f"path {sr.iter_current}")
        for name in ("theta_low", "c_low", "c_high"):
            np.testing.assert_allclose(getattr(st, name), getattr(sr, name),
                                       rtol=1e-8, err_msg=f"{dev} {label}")
        np.testing.assert_allclose(theta, ref_theta, rtol=1e-8)
        print(f"RAT iLQR++ f64 cold solve, {dev} {label}: θ_opt "
              f"{theta:.12g}, c_low {st.c_low:.12g}, c_high "
              f"{st.c_high:.12g}, {st.iter_current} NM iterations, value "
              f"{value:.12g}, {secs:.1f} s", flush=True)
    print("RAT iLQR++ f64: the card and the CPU, host and single-call "
          "paths, take the same decisions (θ_opt, c_low, c_high within "
          "rtol 1e-8, equal iterations)", flush=True)


def pets_phase(device, name_power):
    """Phase 8b: PETS on ``gmm_integrator`` at the JAX bench's pets_16k
    cell in float32, one ``solve`` timed (median of 3) and profiled under
    both models; then ``tests_support.uniform_problem`` in float64 on the
    card and on the CPU with the same control draws."""
    f32, f64, cpu = torch.float32, torch.float64, torch.device("cpu")
    K, M = PETS_CONFIG.num_control_samples, PETS_CONFIG.num_trajectory_samples
    prob = gmm_integrator(N=PETS_T, dtype=f32, device=device)
    state = pets.init_state(
        torch.zeros((PETS_T, 2), dtype=f32, device=device),
        torch.eye(2, dtype=f32, device=device).expand(PETS_T, 2, 2))
    x0 = torch.zeros(2, dtype=f32, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    for true_model in (False, True):
        def run():
            return pets.solve(prob, PETS_CONFIG, x0, state, gen, true_model)

        out = run()   # warm-up
        secs = sorted(sync_time(run)[1] for _ in range(3))[1]
        out, wall, busy = device_busy(run)
        assert out.iter_current == PETS_CONFIG.iter_max
        assert bool(torch.isfinite(out.mu).all()) and bool(
            torch.isfinite(out.sigma).all()), "PETS: non-finite distribution"
        gens = PETS_CONFIG.iter_max / secs
        print(f"PETS gmm_integrator T={PETS_T} f32 K={K} M={M} "
              f"use_true_model={true_model}: solve {secs * 1e3:.1f} ms "
              f"(median of 3, host clock), {gens:.2f} generations/s, "
              f"{gens * K * M:.1f} rollouts/s; profiled run {wall:.3f} s "
              f"wall, device busy {busy * 1e3:.1f} ms, idle share "
              f"{1 - busy / wall:.4f} ({name_power})", flush=True)

    T = 20
    zs = torch.randn((PETS_CONFIG.iter_max, K, T, 2),
                     generator=torch.Generator().manual_seed(1), dtype=f64)
    out = []
    for dev in (device, cpu):
        st = pets.init_state(torch.zeros((T, 2), dtype=f64),
                             torch.eye(2, dtype=f64).expand(T, 2, 2))
        prob = tests_support.uniform_problem(N=T, device=dev)
        g = torch.Generator(device=dev).manual_seed(2)
        for z in zs:
            st = pets.step(prob, PETS_CONFIG, torch.zeros(2, dtype=f64), st,
                           g, z=z.to(dev))
        out.append(st)
    diff = {}
    for name in ("mu", "sigma"):
        a, b = (getattr(o, name).cpu() for o in out)
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12)
        diff[name] = float((a - b).abs().max())
    print(f"PETS f64 uniform problem T={T}, {PETS_CONFIG.iter_max} "
          f"generations with the same control draws: card and CPU μ, Σ "
          f"within 1e-12 (max |Δμ| {diff['mu']:.3e}, |ΔΣ| "
          f"{diff['sigma']:.3e})", flush=True)


def ce_thetas64():
    """64 of the CE generation's θ, in float64 (from the CPU's float32
    grid, so the card and the CPU take the same values)."""
    thetas = torch.linspace(1e-4, 0.02, B_CE, dtype=torch.float32)
    return thetas[lane_idx(B_CE)].to(torch.float64)


def ce64(device):
    """The bank of 64 CE θ in float64 on ``device``."""
    f64 = torch.float64
    return lanes(ratilqr.make_cost_fn(rat_problem(device, f64),
                                      RAT_CONFIG).bank(
        torch.zeros(3, dtype=f64), torch.zeros((T, 2), dtype=f64),
        ce_thetas64()))


def cpu_ce():
    return ce64(torch.device("cpu"))


def ce_generation(device, name_power, job):
    """Phase 8: one CE generation of B_CE lanes, timed and profiled, and 64
    of its θ (as float64) again in float64, on the card and on the CPU
    (plain path).

    In float32 at this noise most inner solves stop at ``iter_max`` with
    ‖Δl‖ just above ``d_tol``: the small-θ risk term amplifies rounding, so
    which iteration a lane stops at depends on it, and two correct float32
    implementations part ways (``PERF.md`` §6).  In float64 the solves
    converge, and the card must take the plain path's decisions."""
    f32, f64 = torch.float32, torch.float64
    cost_fn = ratilqr.make_cost_fn(rat_problem(device), RAT_CONFIG)
    thetas = torch.linspace(1e-4, 0.02, B_CE, dtype=f32, device=device)
    x0 = torch.zeros(3, dtype=f32, device=device)
    u0 = torch.zeros((T, 2), dtype=f32, device=device)
    res, secs = sync_time(lambda: cost_fn.bank(x0, u0, thetas))
    costs = ratilqr.costs_of(res, thetas, KL_BOUND)
    n_failed = int(res.failed.sum())
    assert n_failed == 0, f"CE generation: {n_failed} failed lanes"
    assert bool(torch.isfinite(costs).all())
    _, wall, busy = device_busy(lambda: cost_fn(x0, u0, thetas, KL_BOUND))
    assert busy > 0, "the profiled CE generation ran nothing on the card"
    print(f"CE generation B={B_CE} (unicycle T={T}, f32): 0 failed, costs "
          f"{float(costs.min()):.6f}..{float(costs.max()):.6f}, iterations "
          f"{int(res.iterations.min())}..{int(res.iterations.max())}; "
          f"first run {secs:.3f} s (host clock); "
          f"profiled run {wall:.3f} s wall, device busy "
          f"{busy * 1e3:.1f} ms, idle share {1 - busy / wall:.4f} "
          f"({name_power})", flush=True)

    gpu, cpu = ce64(device), job.result()[0]
    assert not bool(cpu["failed"].any()), "float64 CE lanes failed on the CPU"
    assert torch.equal(cpu["failed"], gpu["failed"]), "failed lanes differ"
    assert torch.equal(cpu["iterations"], gpu["iterations"]), (
        f"iterations differ: cpu {cpu['iterations'].tolist()} "
        f"gpu {gpu['iterations'].tolist()}")
    th64 = ce_thetas64()
    cpu_costs = cpu["value"] + KL_BOUND / th64
    gpu_costs = gpu["value"] + KL_BOUND / th64
    torch.testing.assert_close(gpu_costs, cpu_costs, rtol=1e-3, atol=0)
    rel = float(((gpu_costs - cpu_costs) / cpu_costs).abs().max())
    it = cpu["iterations"]
    print(f"64 CE θ in float64 on the card vs the plain path on the CPU: "
          f"failed and iterations ({int(it.min())}..{int(it.max())}) equal, "
          f"cost max rel diff {rel:.3e}", flush=True)


def seed_generators(n: int, first: int = 0):
    """One CPU generator a seed, seeded ``first``, ``first + 1``, ..."""
    return [torch.Generator().manual_seed(first + s) for s in range(n)]


def ileqg_fleet(prob, steps):
    return make_fleet_runner(make_ileqg_plan(prob, FLEET_CONFIG, 0.0),
                             make_gaussian_simulator(prob), steps, prob.c)


def rat_fleet(prob, steps, plan=None):
    return make_fleet_runner(
        plan or make_ratilqr_plan(prob, RAT_FLEET_CONFIG, FLEET_KL),
        make_gaussian_simulator(prob), steps, prob.c)


def f32_noise_world(prob):
    """The Gaussian world of ``prob`` (float64) fed the float32 draws a
    float32 fleet's world takes from the same generators."""
    f = torch.func.vmap(prob.f)

    def simulate(k, x, u, generators):
        chol = torch.linalg.cholesky(prob.W(k))
        z = torch.stack([torch.randn(x.shape[1:], generator=g,
                                     dtype=torch.float32)
                         for g in generators]).to(x.device, x.dtype)
        return f(x, u) + torch.einsum("ij,sj->si", chol, z)

    return simulate


def fleet_ileqg(device, name_power):
    """Phase 8c, first part: the iLEQG fleet at full width (FLEET_SEEDS x
    FLEET_STEPS), timed by ``time_fn`` (FLEET_TIMED runs), its warm-up run
    with the launch and host-sync counts read around it, and the first
    FLEET_PROFILED steps profiled; the host-loop comparator; seeds 0-3
    against one-seed episodes under the f32 rule.  Returns the launch
    counts."""
    f32 = torch.float32
    prob = unicycle(N=FLEET_T, dtype=f32, device=device)
    x0 = torch.zeros(3, dtype=f32, device=device)
    u0 = torch.zeros((FLEET_T, 2), dtype=f32, device=device)
    run = ileqg_fleet(prob, FLEET_STEPS)
    first = {}

    def episodes():
        """The fleet; its first run (time_fn's warm-up) with the launches
        and host syncs counted around it."""
        if first:
            return run(x0, u0, seed_generators(FLEET_SEEDS))
        _build.reset_launch_counts()
        with count_host_syncs() as syncs:
            out = run(x0, u0, seed_generators(FLEET_SEEDS))
        first.update(out=out, syncs=syncs.n,
                     launched=dict(_build.launch_counts))
        return out

    stats = time_fn(episodes, warmup=1, reps=FLEET_TIMED)
    out, launched = first["out"], first["launched"]
    expect_path("iLEQG fleet", launched, FLEET_KERNELS)
    assert out.xs.shape == (FLEET_SEEDS, FLEET_STEPS + 1, 3)
    assert bool(torch.isfinite(out.xs).all()) and bool(
        torch.isfinite(out.values).all()), "iLEQG fleet: non-finite"
    # The profiler's post-processing of a whole fleet's events takes
    # ~60 s, so the idle share is read over its first FLEET_PROFILED
    # steps (the cold start, whose banks run the most rounds).
    _, wall, busy = device_busy(lambda: ileqg_fleet(prob, FLEET_PROFILED)(
        x0, u0, seed_generators(FLEET_SEEDS)))
    med = stats["median"]
    print(f"iLEQG fleet unicycle T={FLEET_T} f32, {FLEET_SEEDS} seeds x "
          f"{FLEET_STEPS} steps (one bank of {FLEET_SEEDS} lanes a step): "
          f"{FLEET_SEEDS / med:.3f} episodes/s, "
          f"{FLEET_SEEDS * FLEET_STEPS / med:.2f} re-plans/s (median of "
          f"{FLEET_TIMED} by time_fn: {med:.3f} s a fleet, best "
          f"{stats['best']:.3f} s, "
          f"first call {stats['compile']:.3f} s, host syncs counted); "
          f"{first['syncs'] / FLEET_STEPS:.1f} host syncs a step; profiled "
          f"run of steps 0-{FLEET_PROFILED - 1} {wall:.3f} s wall, device "
          f"busy {busy * 1e3:.1f} ms, idle share {1 - busy / wall:.4f}; "
          f"launches riccati "
          f"{launched.get('riccati', 0)} candidate "
          f"{launched.get('candidate', 0)}; mean total cost "
          f"{float(out.total_cost.mean()):.6f} ({name_power})", flush=True)

    steps = 1   # the host-loop comparator: one seed through MPCDriver
    driver = MPCDriver(prob, lambda x, u, g: ileqg.solve(
        prob, FLEET_CONFIG, x, u, 0.0))
    _, secs = sync_time(lambda: driver.run(x0, u0, seed_generators(1)[0],
                                           steps))
    host_eps = 1.0 / (secs / steps * FLEET_STEPS)
    print(f"iLEQG host loop (MPCDriver, one seed, {steps} steps scaled to "
          f"{FLEET_STEPS}): {host_eps:.4f} episodes/s, "
          f"{steps / secs:.3f} re-plans/s; the fleet "
          f"{FLEET_SEEDS / med / host_eps:.1f}x its episodes/s "
          f"({name_power})", flush=True)

    # Seeds 0-3 against one-seed episodes with the same generators, and
    # the f32 rule's reference: the same episodes in float64.
    S, k = FLEET_CHECKED
    one = make_episode_runner(make_ileqg_plan(prob, FLEET_CONFIG, 0.0),
                              make_gaussian_simulator(prob), k, prob.c)
    eps = [one(x0, u0, torch.Generator().manual_seed(s)) for s in range(S)]
    prob64 = unicycle(N=FLEET_T, dtype=torch.float64, device=device)
    ref = make_fleet_runner(make_ileqg_plan(prob64, FLEET_CONFIG, 0.0),
                            f32_noise_world(prob64), k, prob64.c)(
        x0.double(), u0.double(), seed_generators(S))
    lanes = torch.ones(S, dtype=torch.bool, device=device)
    theta = torch.zeros(S, device=device)
    traj = kernel_check.TOL[f32]["traj"]
    errs = {}
    for name, got in (("xs", out.xs[:S, :k + 1]), ("us", out.us[:S, :k])):
        want = torch.stack([getattr(e, name) for e in eps])
        tol, drift = kernel_check._drift_atol(want, getattr(ref, name),
                                              lanes, theta, traj["atol"])
        errs[name] = (kernel_check._close(
            f"iLEQG fleet {name}, seeds 0-{S - 1}", got, want, lanes,
            traj["rtol"], tol), float(tol.max()), drift)
    print(f"iLEQG fleet seeds 0-{S - 1}, steps 0-{k - 1}, against one-seed "
          f"episodes with the same generators (f32): " + ", ".join(
              f"max |Δ{name}| {e:.3e} (allowed {a:.3e} + rtol "
              f"{traj['rtol']}; one-seed f32 vs f64 {d:.3e})"
              for name, (e, a, d) in errs.items()), flush=True)
    return launched


def fleet_ratilqr(device, name_power):
    """Phase 8c, second part: the RAT iLQR fleet at full width
    (RAT_FLEET_SEEDS seeds, banks of RAT_FLEET_SEEDS x num_samples lanes),
    RAT_FLEET_STEPS steps; returns the launch counts."""
    f32 = torch.float32
    prob = unicycle(N=FLEET_T, dtype=f32, device=device)
    x0 = torch.zeros(3, dtype=f32, device=device)
    u0 = torch.zeros((FLEET_T, 2), dtype=f32, device=device)
    plan = make_ratilqr_plan(prob, RAT_FLEET_CONFIG, FLEET_KL)
    marks = []

    def plan_step(*args):
        marks.append(len(widths))
        return plan(*args)

    run = rat_fleet(prob, RAT_FLEET_STEPS, plan_step)
    _build.reset_launch_counts()
    with ileqg.record_banks() as widths, count_host_syncs() as syncs:
        out, secs = sync_time(lambda: run(
            x0, u0, seed_generators(RAT_FLEET_SEEDS),
            ratilqr.init_state(RAT_FLEET_CONFIG, f32)))
    launched = dict(_build.launch_counts)
    expect_path("RAT iLQR fleet", launched, FLEET_KERNELS)
    theta = out.aux["theta_opt"]
    assert bool(torch.isfinite(out.values).all()) and bool(
        (theta > 0).all()), "RAT iLQR fleet: an infeasible or θ = 0 plan"
    marks.append(len(widths))
    for k in range(RAT_FLEET_STEPS):
        step = widths[marks[k]:marks[k + 1]]
        print(f"RAT iLQR fleet step {k}: {len(step)} banks "
              f"({widths_text(step)})", flush=True)
    n = RAT_FLEET_SEEDS * RAT_FLEET_STEPS
    print(f"RAT iLQR fleet unicycle T={FLEET_T} f32, {RAT_FLEET_SEEDS} "
          f"seeds x {RAT_FLEET_STEPS} steps (benchmarks/run_all.py runs 10 "
          f"steps; cut to {RAT_FLEET_STEPS} for time), CE "
          f"{RAT_FLEET_CONFIG.num_samples} samples x "
          f"{RAT_FLEET_CONFIG.iter_max} generations, kl_bound {FLEET_KL}: "
          f"{secs:.3f} s, {n / secs:.3f} re-plans/s, "
          f"{RAT_FLEET_SEEDS / secs:.4f} episodes/s of {RAT_FLEET_STEPS} "
          f"steps (one run, host clock, device synchronized); mean θ_opt "
          f"{float(theta.double().mean()):.6g}; {syncs.n / RAT_FLEET_STEPS:.1f} "
          f"host syncs a step; launches riccati "
          f"{launched.get('riccati', 0)} candidate "
          f"{launched.get('candidate', 0)} ({name_power})", flush=True)
    return launched


def fleets64(device) -> dict:
    """The float64 fleets of FLEET64 on ``device``, with CPU generators:
    ``{"ileqg": EpisodeResult, "ratilqr": EpisodeResult}`` on the CPU.
    The unicycle with closed-form Jacobians keeps the CPU runs short."""
    f64 = torch.float64
    prob = unicycle(N=FLEET_T, dtype=f64, device=device,
                    analytic_jacobians=True)
    x0 = torch.zeros(3, dtype=f64, device=device)
    u0 = torch.zeros((FLEET_T, 2), dtype=f64, device=device)
    S, k = FLEET64["ileqg"]
    il = ileqg_fleet(prob, k)(x0, u0, seed_generators(S))
    S, k = FLEET64["ratilqr"]
    rat = rat_fleet(prob, k)(x0, u0, seed_generators(S),
                             ratilqr.init_state(RAT_FLEET_CONFIG))
    return tree_map(lambda t: t.cpu() if isinstance(t, torch.Tensor) else t,
                    {"ileqg": il, "ratilqr": rat})


def cpu_fleets():
    return fleets64(torch.device("cpu"))


def fleet_f64_parity(device, job):
    """Phase 8c, third part: the float64 fleets on the card against the
    CPU (the same CPU generators on both sides): xs, us and values within
    1e-9, θ_opt equal; then the RAT fleet's final plan_state through a
    checkpoint: its continuation equals the live state's bit for bit."""
    card, cpu = fleets64(device), job.result()[0]
    for name, (S, k) in FLEET64.items():
        diffs = {}
        for field in ("xs", "us", "values"):
            a, b = getattr(card[name], field), getattr(cpu[name], field)
            torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-9,
                                       msg=f"{name} fleet {field}")
            diffs[field] = float((a - b).abs().max())
        extra = ""
        if name == "ratilqr":
            a, b = card[name].aux["theta_opt"], cpu[name].aux["theta_opt"]
            assert torch.equal(a, b), f"θ_opt differ: {a} {b}"
            extra = f"; θ_opt equal ({a.flatten().tolist()})"
        print(f"{name} fleet f64, {S} seeds x {k} steps, card against CPU "
              "(same CPU generators): " + ", ".join(
                  f"max |Δ{f}| {d:.3e}" for f, d in diffs.items())
              + f" (within 1e-9){extra}", flush=True)

    live = card["ratilqr"].plan_state
    f64 = torch.float64
    prob = unicycle(N=FLEET_T, dtype=f64, device=device,
                    analytic_jacobians=True)
    S = FLEET64["ratilqr"][0]
    x = card["ratilqr"].xs[:, -1].to(device)
    u0 = torch.zeros((FLEET_T, 2), dtype=f64, device=device)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "fleet_state.npz")
        save_state(path, live)
        restored = load_state(path, live)
    run = rat_fleet(prob, 1)
    a = run(x, u0, seed_generators(S, 100), live)
    b = run(x, u0, seed_generators(S, 100), restored)
    for field in ("xs", "us", "values", "total_cost"):
        assert torch.equal(getattr(a, field), getattr(b, field)), field
    assert torch.equal(a.aux["theta_opt"], b.aux["theta_opt"])
    assert all(torch.equal(p, q) for p, q in zip(a.plan_state,
                                                 b.plan_state))
    print(f"RAT iLQR fleet checkpoint: the {S}-seed final plan_state saved "
          "and loaded; a 1-step continuation from it equals the live "
          "state's bit for bit (xs, us, values, θ_opt, plan_state)",
          flush=True)


def serving_phase(device, name_power):
    """Phase 8c, last part: ``ILEQGBankServer`` (bank_size SERVE_BANK) on
    SERVE_REQUESTS requests of the unicycle bench configuration, every lane
    against one direct bank on the same requests, bit for bit."""
    f32 = torch.float32
    prob = unicycle(N=T, dtype=f32, device=device)
    R = SERVE_REQUESTS
    x0s = (0.1 * torch.randn((R, 3), generator=torch.Generator()
                             .manual_seed(3))).to(device)
    u0s = torch.zeros((R, T, 2), dtype=f32, device=device)
    thetas = torch.linspace(0.0, 0.02, R, dtype=f32, device=device)
    server = ILEQGBankServer(prob, BENCH_CONFIG, bank_size=SERVE_BANK,
                             depth=2)
    with ileqg.record_banks() as widths:
        got, secs = sync_time(lambda: server.solve_batch(x0s, u0s, thetas))
    direct, direct_secs = sync_time(lambda: make_batched_solver(
        prob, BENCH_CONFIG)(x0s, u0s, thetas))
    for name, a, b in zip(direct._fields, got, direct):
        assert a.shape[0] == R and torch.equal(a, b.cpu()), (
            f"server {name} differs from the direct bank")
    print(f"bank server unicycle T={T} f32 bench configuration: {R} "
          f"requests in {len(widths)} banks of {SERVE_BANK} (the last "
          f"padded from {R - (len(widths) - 1) * SERVE_BANK}), "
          f"{int(got.failed.sum())} failed; every lane equals one direct "
          f"bank of {R} bit for bit; {R / secs:.1f} solves/s ({secs:.3f} s;"
          f" the direct bank {R / direct_secs:.1f} solves/s), host clock "
          f"({name_power})", flush=True)


def fleets_phase(device, name_power, job):
    """Phase 8c: MPC fleets, the checkpoint and the bank server; returns
    the launch counts of the two fleet paths."""
    counts = {"fleet_ileqg": fleet_ileqg(device, name_power),
              "fleet_ratilqr": fleet_ratilqr(device, name_power)}
    fleet_f64_parity(device, job)
    serving_phase(device, name_power)
    return counts


def bench_inputs(device, B, u_warm=None):
    """The bench bank's warm inputs (bench.py:90-117), float32: the
    problem, x0 + X_MPC, the warm start (by default the schedule of a cold
    one-lane solve at θ = 0) and θ = linspace(0, 0.02, B)."""
    f32 = torch.float32
    prob = unicycle(N=T, dtype=f32, device=device)
    x0 = torch.zeros(3, dtype=f32, device=device)
    thetas = torch.linspace(0.0, 0.02, B, dtype=f32, device=device)
    if u_warm is None:
        u_warm = ratilqr.make_cost_fn(prob, SHARDED_CONFIG).bank(
            x0, torch.zeros((T, 2), dtype=f32, device=device),
            thetas[:1]).l[0]
    return (prob, x0 + torch.tensor(X_MPC, dtype=f32, device=device),
            torch.as_tensor(u_warm, device=device), thetas)


def counted(fn):
    """``(fn(), seconds, launch counts)``, the counts set to 0 just before
    and read just after, the card synchronized around it."""
    _build.reset_launch_counts()
    out, secs = sync_time(fn)
    return out, secs, dict(_build.launch_counts)


def assert_equal_trees(name, got, want):
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), f"{name}: field {i} differs"


def sharded_one_rank(device, name_power):
    """Phase 8d, first part: an NCCL group of one rank in this process (a
    ``HashStore``): the sharded θ-bank at B_WIDE, the sharded PETS solve
    at pets_16k through both elite paths and the sharded iLEQG fleet of
    FLEET_SEEDS x SHARDED_FLEET_STEPS, each bit for bit equal to its
    unsharded run; returns the launch counts of the θ-bank and the fleet,
    and the bank's warm start.
    """
    f32 = torch.float32
    parallel.distributed_initialize(device=device, store=dist.HashStore(),
                                    rank=0, world_size=1)
    try:
        mesh = parallel.make_mesh(device=device)
        backend = dist.get_backend()
        prob, x_mpc, u_warm, thetas = bench_inputs(device, B_WIDE)
        sharded = parallel.make_sharded_theta_cost_fn(prob, SHARDED_CONFIG,
                                                      mesh)
        plain = ratilqr.make_cost_fn(prob, SHARDED_CONFIG)
        args = (x_mpc, u_warm, thetas, KL_BOUND)
        plain(*args)   # warm-up at this width
        costs, first, bank_counts = counted(lambda: sharded(*args))
        expect_path("sharded θ-bank", bank_counts, ("step", "candidate"))
        again, secs = sync_time(lambda: sharded(*args))
        ref, ref_secs = sync_time(lambda: plain(*args))
        assert torch.equal(costs, ref) and torch.equal(again, ref), (
            "sharded θ-bank differs")
        assert bool(torch.isfinite(costs[1:]).all()), "infeasible θ > 0"
        print(f"sharded θ-bank ({backend}, 1 rank) unicycle T={T} f32 "
              f"B={B_WIDE}, bench configuration, warm: equal bit for bit "
              f"to the unsharded bank; {secs * 1e3:.1f} ms sharded (first "
              f"call {first * 1e3:.1f} ms, the communicator's set-up "
              f"included), {ref_secs * 1e3:.1f} ms unsharded (host clock, "
              f"card synchronized; {name_power}); launches {bank_counts}",
              flush=True)

        K, M = (PETS_CONFIG.num_control_samples,
                PETS_CONFIG.num_trajectory_samples)
        gmm = gmm_integrator(N=PETS_T, dtype=f32, device=device)
        state = pets.init_state(
            torch.zeros((PETS_T, 2), dtype=f32, device=device),
            torch.eye(2, dtype=f32, device=device).expand(PETS_T, 2, 2))
        x0 = torch.zeros(2, dtype=f32, device=device)

        def gen():
            return torch.Generator(device=device).manual_seed(0)

        pets.solve(gmm, PETS_CONFIG, x0, state, gen())   # warm-up
        ref, ref_secs = sync_time(lambda: pets.solve(gmm, PETS_CONFIG, x0,
                                                     state, gen()))
        for shard_elites in (False, True):
            solve = parallel.make_sharded_pets_solve(
                gmm, PETS_CONFIG, mesh, shard_elites=shard_elites)
            out, secs = sync_time(lambda: solve(x0, state, gen()))
            assert_equal_trees(f"sharded PETS (shard_elites={shard_elites})",
                               out[:2], ref[:2])
            print(f"sharded PETS ({backend}, 1 rank) gmm_integrator "
                  f"T={PETS_T} f32 K={K} M={M}, {PETS_CONFIG.iter_max} "
                  f"generations, shard_elites={shard_elites}: μ, Σ equal "
                  f"bit for bit to pets.solve; {secs * 1e3:.1f} ms sharded, "
                  f"{ref_secs * 1e3:.1f} ms unsharded (host clock; "
                  f"{name_power})", flush=True)

        uni = unicycle(N=FLEET_T, dtype=f32, device=device)
        x0 = torch.zeros(3, dtype=f32, device=device)
        u0 = torch.zeros((FLEET_T, 2), dtype=f32, device=device)
        fleet = parallel.make_sharded_fleet_runner(
            mesh, make_ileqg_plan(uni, FLEET_CONFIG, 0.0),
            make_gaussian_simulator(uni), SHARDED_FLEET_STEPS, uni.c)
        out, secs, fleet_counts = counted(lambda: fleet(
            x0, u0, seed_generators(FLEET_SEEDS)))
        expect_path("sharded iLEQG fleet", fleet_counts, FLEET_KERNELS)
        ref, ref_secs = sync_time(lambda: ileqg_fleet(
            uni, SHARDED_FLEET_STEPS)(x0, u0, seed_generators(FLEET_SEEDS)))
        assert_equal_trees("sharded iLEQG fleet", out[:5], ref[:5])
        assert bool(torch.isfinite(out.xs).all())
        print(f"sharded iLEQG fleet ({backend}, 1 rank) unicycle "
              f"T={FLEET_T} f32, {FLEET_SEEDS} seeds x "
              f"{SHARDED_FLEET_STEPS} steps: xs, us, values, fallbacks, "
              f"total_cost equal bit for bit to the unsharded fleet; "
              f"{secs:.3f} s sharded, {ref_secs:.3f} s unsharded (host "
              f"clock; {name_power}); launches {fleet_counts}", flush=True)
    finally:
        dist.destroy_process_group()
    return ({"sharded_theta_bank": bank_counts,
             "sharded_fleet": fleet_counts}, u_warm)


def sharded_rank(rank: int, world: int, port: int, device: str, B: int,
                 u_warm: np.ndarray, results) -> None:
    """One rank of the gloo group that shares the card: the sharded θ-bank
    at B on its block of θ; reports ``(rank, costs, seconds, launch
    counts, whether gloo gathered a CUDA tensor, error)``."""
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        device = parallel.distributed_initialize(
            device=device, backend="gloo",
            init_method=f"tcp://localhost:{port}", rank=rank,
            world_size=world)
        mesh = parallel.make_mesh(device=device)
        probe = [torch.empty(1, device=device) for _ in range(world)]
        dist.all_gather(probe, torch.full((1,), float(rank), device=device))
        gathered = [float(p) for p in probe] == [float(r)
                                                 for r in range(world)]
        prob, *args = bench_inputs(device, B, u_warm)
        cost_fn = parallel.make_sharded_theta_cost_fn(prob, SHARDED_CONFIG,
                                                      mesh)
        args = (*args, KL_BOUND)
        cost_fn(*args)   # warm-up
        costs, secs, launched = counted(lambda: cost_fn(*args))
        dist.destroy_process_group()
        results.put((rank, costs.cpu().numpy(), secs, launched, gathered,
                     None))
    except BaseException:
        results.put((rank, None, None, None, None, traceback.format_exc()))


def gather_results(results, procs, timeout_s: float) -> list:
    """One result ``(..., error)`` from each process in ``procs``, or the
    results so far once one reports an error; fails when a process has
    died without reporting, or after ``timeout_s``."""
    got, deadline = [], time.monotonic() + timeout_s
    while len(got) < len(procs):
        try:
            got.append(results.get(timeout=1.0))
        except queue.Empty:
            exits = [p.exitcode for p in procs]
            assert any(p.exitcode is None for p in procs), (
                f"ranks exited with codes {exits} without reporting")
            assert time.monotonic() < deadline, (
                f"a rank gave no result in {timeout_s} s")
            continue
        if got[-1][-1] is not None:
            break
    return got


def sharded_ranks(device, name_power, u_warm):
    """Phase 8d, second part: SHARDED_RANKS spawned processes on one card
    in a gloo group (NCCL refuses two ranks on one GPU), the sharded
    θ-bank at B_MAIN from the warm start ``u_warm`` against the unsharded
    bank in this process, bit for bit; returns the ranks' summed launch
    counts."""
    prob, x_mpc, u_warm, thetas = bench_inputs(device, B_MAIN, u_warm)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=sharded_rank, args=(
        r, SHARDED_RANKS, port, str(device), B_MAIN,
        u_warm.cpu().numpy(), results)) for r in range(SHARDED_RANKS)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        got = gather_results(results, procs, RANK_TIMEOUT_S)
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join()
    wall = time.perf_counter() - t0
    errors = [f"rank {r}:\n{err}" for r, *_, err in got if err]
    assert not errors, "\n".join(errors)
    ref = ratilqr.make_cost_fn(prob, SHARDED_CONFIG)(x_mpc, u_warm, thetas,
                                                     KL_BOUND).cpu()
    launched = {}
    for rank, costs, secs, counts, gathered, _ in sorted(got,
                                                         key=lambda g: g[0]):
        assert torch.equal(torch.from_numpy(costs), ref), (
            f"rank {rank}: the sharded θ-bank differs from the unsharded")
        for kernel, n in counts.items():
            launched[kernel] = launched.get(kernel, 0) + n
        print(f"sharded θ-bank (gloo, rank {rank} of {SHARDED_RANKS} on "
              f"{device}) B={B_MAIN}: equal bit for bit to the unsharded "
              f"bank; {secs * 1e3:.1f} ms (host clock; {name_power}); "
              f"gloo all_gather of {device.type} tensors: {gathered}; "
              f"launches {counts}",
              flush=True)
    expect_path("sharded θ-bank on 2 ranks", launched, ("step", "candidate"))
    print(f"{SHARDED_RANKS} gloo ranks on one card: {wall:.1f} s from "
          "spawn to the last result", flush=True)
    return {f"sharded_theta_bank_{SHARDED_RANKS}_ranks": launched}


def parallel_dp(device, name_power):
    """Phase 8d, third part: the parallel-in-time Riccati DP against kernel
    A's sequential pass on the same unicycle approximation, PDP_LANES
    lanes, θ = linspace(0, PDP_THETA_MAX), each horizon of PDP_HORIZONS:
    float64 parity (rtol 1e-8, failures equal), both times in float64 and
    float32, and each float32 pass's error against the float64 sequential
    pass on the same (cast) approximation."""
    f64 = torch.float64
    dp_args = dict(mu=0.0, delta=2.0, mu_min=1e-6, delta_0=2.0)
    for horizon in PDP_HORIZONS:
        g = torch.Generator().manual_seed(horizon)
        x0s = (0.1 * torch.randn((PDP_LANES, 3), generator=g,
                                 dtype=f64)).to(device)
        u = (0.1 * torch.randn((PDP_LANES, horizon, 2), generator=g,
                               dtype=f64)).to(device)
        prob = unicycle(N=horizon, dtype=f64, device=device,
                        analytic_jacobians=True)
        ap = approximate_model(prob, u, *rollout_open_loop_with_jac(
            prob, x0s, u))
        theta = torch.linspace(0.0, PDP_THETA_MAX, PDP_LANES, dtype=f64,
                               device=device)
        seq = dp_optimize(ap, theta=theta, **dp_args)
        par = dp_optimize_parallel(ap, theta=theta, **dp_args)
        ok = ~seq[-1]
        assert torch.equal(seq[-1], par[-1]), "failed lanes differ"
        assert bool(ok[0]), "the θ = 0 lane must be feasible"
        for name, a, b in (("s", par[0].s, seq[0].s), ("S", par[0].S,
                                                         seq[0].S),
                           ("L", par[1], seq[1])):
            torch.testing.assert_close(a[ok], b[ok], rtol=1e-8, atol=1e-10,
                                       msg=lambda m: f"T={horizon} {name}: "
                                       + m)
        times, errs = {}, {}
        for dtype in (f64, torch.float32):
            a = Approximation(*(t.to(dtype) for t in ap))
            th = theta.to(dtype)
            for name, fn in (("kernel A", dp_optimize),
                             ("parallel", dp_optimize_parallel)):
                times[name, dtype] = kernel_check.time_ms(
                    lambda: fn(a, theta=th, **dp_args))
                if dtype == torch.float32:
                    out = fn(a, theta=th, **dp_args)
                    both = ok & ~out[-1]
                    errs[name] = (float(((out[0].s[both].double()
                                          - seq[0].s[both]).abs()
                                         / seq[0].s[both].abs()).max()),
                                  int((out[-1] != seq[-1]).sum()))
        print(f"parallel DP unicycle T={horizon} B={PDP_LANES}, θ in [0, "
              f"{PDP_THETA_MAX}]: {int(ok.sum())} feasible lanes; float64 "
              f"equal to kernel A's sequential pass (rtol 1e-8); times "
              + ", ".join(f"{name} {str(dt)[6:]} {ms:.3f} ms"
                          for (name, dt), ms in times.items())
              + " (median of 5, CUDA events, μ-restart loop included); "
              "float32 max relative value error against float64 "
              "sequential: " + ", ".join(
                  f"{name} {e:.3e} ({flips} lanes' failure flag differs)"
                  for name, (e, flips) in errs.items())
              + f" ({name_power})", flush=True)


def sharded_phase(device, name_power):
    """Phase 8d: the distributed layer and the parallel-in-time DP;
    returns the launch counts of the sharded paths."""
    counts, u_warm = sharded_one_rank(device, name_power)
    counts.update(sharded_ranks(device, name_power, u_warm))
    parallel_dp(device, name_power)
    return counts


def timings(device, name_power):
    """Phase 9: returns {(model, B): {kernel: record}} with each kernel's
    wrapper, launch-alone and plain times and its bound."""
    f32 = torch.float32
    result = {}
    # The kernel record's widths, and both for the quadrotor; the unicycle
    # at B=16,384 and the cartpole at B=262,144 are left out to keep the
    # run short (PERF.md keeps their last numbers).
    for model, horizon, B in (("unicycle", T, B_WIDE),
                              ("quadrotor", QUAD_T, B_MAIN),
                              ("quadrotor", QUAD_T, B_WIDE),
                              ("cartpole", CART_T, B_MAIN)):
        n, m = MODEL_DIMS[model]
        times = kernel_check.kernel_timings(model, horizon, B, f32, device)
        for kernel, (ms, launch_ms, plain_ms) in times.items():
            bound, by = kernel_check.bound_ms(kernel, n, m, horizon, B, f32)
            result.setdefault((model, B), {})[kernel] = dict(
                ms=ms, launch_ms=launch_ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by)
            plain = ("not measured (out of device memory)"
                     if plain_ms is None else f"{plain_ms:.3f} ms")
            print(f"time {kernel} {model} T={horizon} B={B} f32: wrapper "
                  f"{ms:.3f} ms, launch alone {launch_ms:.3f} ms, plain "
                  f"{plain}, bound {bound:.3f} ms ({by}) (median of 5, "
                  f"the plain version one run, after a warm-up each, CUDA "
                  f"events; {name_power})",
                  flush=True)
    for B in NM_WIDTHS:   # RAT iLQR++'s one-lane and depth-3 banks
        times = kernel_check.kernel_timings("unicycle", NM_T, B, f32, device)
        for kernel, (ms, launch_ms, plain_ms) in times.items():
            bound, by = kernel_check.bound_ms(kernel, 3, 2, NM_T, B, f32)
            result.setdefault(("unicycle_nm", B), {})[kernel] = dict(
                ms=ms, launch_ms=launch_ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by)
            print(f"time {kernel} unicycle T={NM_T} B={B} f32 (RAT iLQR++ "
                  f"widths): wrapper {ms:.4f} ms, launch alone "
                  f"{launch_ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
                  f"{bound:.5f} ms ({by}) (median of 5, the plain version "
                  f"one run, after a warm-up each, CUDA events; "
                  f"{name_power})", flush=True)
    # RAT iLQR's banks: kernel B alone, no plain version.
    _, layout, launch, _ = kernel_check.timing_cases(
        "unicycle", T, RAT_WIDTH, f32, device)["step"]()
    args = layout()
    launch_ms = kernel_check.time_ms(lambda: launch(args))
    bound, by = kernel_check.bound_ms("step", 3, 2, T, RAT_WIDTH, f32)
    lanes = step_cuda.block_shared_memory(tile_model.UNICYCLE, f32,
                                          RAT_WIDTH)[2]
    result[("unicycle_rat", RAT_WIDTH)] = {"step": dict(
        launch_ms=launch_ms, bound_ms=bound, bound_by=by, lanes=lanes)}
    print(f"time step unicycle T={T} B={RAT_WIDTH} f32 (RAT iLQR's width, "
          f"{lanes} lanes a solve): launch alone {launch_ms:.4f} ms, bound "
          f"{bound:.5f} ms ({by}) (median of 5, after a warm-up, CUDA "
          f"events; {name_power})", flush=True)
    del args
    for B in FLEET_WIDTHS:   # the fleets' banks: kernel C alone, no plain
        _, layout, launch, _ = kernel_check.timing_cases(
            "unicycle", FLEET_T, B, f32, device)["candidate"]()
        args = layout()
        launch_ms = kernel_check.time_ms(lambda: launch(args))
        bound, by = kernel_check.bound_ms("candidate", 3, 2, FLEET_T, B, f32)
        lanes = candidate_cuda.block_shared_memory(tile_model.UNICYCLE, f32,
                                                   B)[2]
        result[("unicycle_fleet", B)] = {"candidate": dict(
            launch_ms=launch_ms, bound_ms=bound, bound_by=by, lanes=lanes)}
        print(f"time candidate unicycle T={FLEET_T} B={B} f32 (the fleets' "
              f"widths, {lanes} lanes a solve): launch alone "
              f"{launch_ms:.4f} ms, bound {bound:.5f} ms ({by}) (median of "
              f"5, after a warm-up, CUDA events; {name_power})", flush=True)
        del args
    prob = unicycle(N=T, dtype=f32, device=device)
    bank = make_batched_solver(prob, BENCH_CONFIG, device=device)
    x0 = torch.zeros(3, dtype=f32, device=device)
    x_mpc = x0 + torch.tensor(X_MPC, dtype=f32, device=device)
    for B in (B_MAIN, B_WIDE):
        thetas = torch.linspace(0.0, 0.02, B, dtype=f32, device=device)
        u_warm = bank(x0, torch.zeros((T, 2), dtype=f32, device=device),
                      thetas[:1]).l[0]
        bank(x_mpc, u_warm, thetas)   # warm-up at this width
        secs = sorted(sync_time(lambda: bank(x_mpc, u_warm, thetas))[1]
                      for _ in range(3))[1]
        print(f"warm re-plan T={T} B={B} f32: {B / secs:.1f} solves/s "
              f"({secs * 1e3:.1f} ms, median of 3, host clock; "
              f"{name_power})", flush=True)
    return result


def kernel_record(err32, quad_counts, cart_counts, earlier_counts, times):
    """The JSON kernel record: the quadrotor path (T=50, B=16,384, f32) at
    the top level, the cartpole path (T=50, B=16,384, f32) under
    ``"cartpole"``, the unicycle path at B=262,144 under ``"unicycle"``,
    the quadrotor at B=262,144 under ``"quadrotor_wide"``, the unicycle
    at T=30 at RAT iLQR++'s widths under ``"unicycle_nm"``, (kernel C,
    launch alone) at the fleets' widths under ``"unicycle_fleet"`` and
    (kernel B, launch alone) at RAT iLQR's width (T=100, B=10) under
    ``"unicycle_rat"``."""
    rows = []
    for name, (src, rep) in KERNELS.items():
        quad = times[("quadrotor", B_MAIN)][name]
        uni = times[("unicycle", B_WIDE)][name]
        cart = times[("cartpole", B_MAIN)][name]
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "design": DESIGNS[name], "shapes": SHAPES[name],
            "launches": sum(c.get(name, 0) for c in quad_counts.values()),
            "launches_by_path": {**{f"quadrotor_{k}": c.get(name, 0)
                                    for k, c in quad_counts.items()},
                                 **{k: c.get(name, 0)
                                    for k, c in earlier_counts.items()}},
            "max_abs_err": err32[name],
            "ms": quad["ms"], "launch_ms": quad["launch_ms"],
            "plain_ms": quad["plain_ms"], "bound_ms": quad["bound_ms"],
            "bound_by": quad["bound_by"], "library_ms": None,
            "at": f"quadrotor n=12 m=4 T={QUAD_T} B={B_MAIN} f32",
            "unicycle": {**uni, "library_ms": None,
                         "at": f"unicycle n=3 m=2 T={T} B={B_WIDE} f32"},
            "cartpole": {
                **cart, "library_ms": None,
                "launches": sum(c.get(name, 0) for c in cart_counts.values()),
                "launches_by_path": {f"cartpole_{k}": c.get(name, 0)
                                     for k, c in cart_counts.items()},
                "at": f"cartpole n=4 m=1 T={CART_T} B={B_MAIN} f32"},
            "quadrotor_wide": {
                **times[("quadrotor", B_WIDE)][name], "library_ms": None,
                "at": f"quadrotor n=12 m=4 T={QUAD_T} B={B_WIDE} f32"},
            "unicycle_nm": {
                f"B={B}": {**times[("unicycle_nm", B)][name],
                           "library_ms": None,
                           "at": f"unicycle n=3 m=2 T={NM_T} B={B} f32"}
                for B in NM_WIDTHS},
            **({"unicycle_fleet": {
                f"B={B}": {**times[("unicycle_fleet", B)][name],
                           "at": f"unicycle n=3 m=2 T={FLEET_T} B={B} f32"}
                for B in FLEET_WIDTHS}} if name == "candidate" else {}),
            **({"unicycle_rat": {
                **times[("unicycle_rat", RAT_WIDTH)][name],
                "at": f"unicycle n=3 m=2 T={T} B={RAT_WIDTH} f32"}}
               if name == "step" else {})})
    return {"kernels": rows}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name_power = card()
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: "
          f"{name_power} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    t_start, t_start_wall = time.perf_counter(), time.time()

    def phase(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.empty_cache()
        print(f"phase {label}: {time.perf_counter() - t0:.1f} s", flush=True)
        return out

    # The CPU halves of the parity checks run in worker processes while
    # the card works; every worker is stopped before the script returns.
    pool = concurrent.futures.ProcessPoolExecutor(
        CPU_WORKERS, mp_context=multiprocessing.get_context("spawn"),
        initializer=torch.set_num_threads, initargs=(CPU_THREADS,))
    try:
        cpu = {name: pool.submit(timed, fn) for name, fn in (
            ("unicycle", cpu_unicycle), ("quadrotor", cpu_quadrotor),
            ("cartpole", cpu_cartpole), ("linear", cpu_linear),
            ("nm", cpu_nm), ("ce", cpu_ce), ("fleets", cpu_fleets))}
        phase("build", build)
        err32 = phase("kernels vs plain", check_kernels, device)
        cold, bank_counts = phase("unicycle bank", main_path, device)
        phase("unicycle CPU parity", plain_cpu_parity, cold, cpu["unicycle"])
        del cold
        quad_counts = phase("quadrotor bank", quadrotor_path, device)
        phase("quadrotor f64 CPU parity", quadrotor_cpu_parity, device,
              cpu["quadrotor"])
        cart_counts = phase("cartpole bank", cartpole_path, device)
        phase("cartpole CPU parity", cartpole_cpu_parity, device,
              cpu["cartpole"])
        linear_counts = phase("any problem", linear_path, device,
                              cpu["linear"])
        rat_counts = phase("RAT iLQR MPC", rat_mpc, device)
        nm_counts = phase("RAT iLQR++ MPC", nm_mpc, device)
        phase("RAT iLQR++ f64 card and CPU", nm_f64_parity, device,
              cpu["nm"])
        phase("CE generation", ce_generation, device, name_power, cpu["ce"])
        phase("PETS", pets_phase, device, name_power)
        fleet_counts = phase("MPC fleets", fleets_phase, device, name_power,
                             cpu["fleets"])
        sharded_counts = phase("sharded", sharded_phase, device, name_power)
        times = phase("timings", timings, device, name_power)
        print(f"CPU halves, in {CPU_WORKERS} worker processes: " + ", ".join(
            f"{name} {job.result()[1]:.1f} s (done "
            f"{job.result()[2] - t_start_wall:.1f} s after the device check)"
            for name, job in cpu.items()), flush=True)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s after the "
          f"device check ({name_power})", flush=True)

    print(json.dumps(kernel_record(
        err32, quad_counts, cart_counts,
        {"unicycle_bank": bank_counts, "rat_ilqr": rat_counts, **nm_counts,
         **fleet_counts, **sharded_counts,
         **{f"{LINEAR}_{k}": c for k, c in linear_counts.items()}}, times)),
        flush=True)
    print(name_power, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
