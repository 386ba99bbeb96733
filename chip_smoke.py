#!/usr/bin/env python3
"""Drive the PyTorch port (the iLEQG solver bank on the unicycle, the
cartpole, the n=12 quadrotor and a problem with no tile model, RAT iLQR and
the MPC driver) on one CUDA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.

Phases (each prints a line and raises on failure):
  1. device: the card's name and power limit; exits non-zero without CUDA;
  2. build: compiles the CUDA kernels from ratilqr_tpu_torch/csrc (one nvcc
     per source, in parallel) and prints each kernel's registers, spills
     and stack frame, and kernels A's, B's and C's one-solve-per-team
     kernels (the quadrotor) with their shared memory a block; then builds
     kernel A at (6, 3) and kernel D at n=6,
     shapes outside the shipped library, float32 and float64, and prints
     each unit's build time and ptxas report;
  3. every kernel against its plain PyTorch version on the card, float32
     and float64, at the unicycle T=100, the LQR T=7, the quadrotor T=50
     and the cartpole T=50 with B=5 and B=4,099 (kernel D with a shared
     and a per-lane noise model), kernels A and D on the random linear
     problem at (6, 3), T=20, kernels A and B on the n=12 h_fail fixture
     (``kernel_check.H_FAIL``), kernel A's slim optimizing pass on the
     quadrotor at B=262,144 in float32, the θ = 1e6 lanes latching m_fail
     and the h_fail fixtures' lanes h_fail;
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
  7. the RAT iLQR path: ``MPCDriver`` re-planning the unicycle (T=100,
     f32) three times through ``RATiLQRSolver`` and through the single-call
     ``ratilqr_jit.solve``, on the folded candidate evaluation (kernel D)
     and the fused step (kernel B), with the launch counts read around
     each path;
  8. one CE generation at width (16,384 θ samples), timed and profiled
     (device idle share), and 64 of its θ again in float64 on the card and
     on the CPU through the plain path;
  9. timings: each kernel's wrapper, its launch alone and its plain
     version, beside its bound, on the unicycle (B=262,144), the
     quadrotor (B=16,384; kernels A, B and C also at 262,144) and the
     cartpole (both); warm solves/s.
The line before the card's name is the JSON kernel record; the last line
is the JSON device record.
"""
import concurrent.futures
import json
import subprocess
import sys
import time

import numpy as np
import torch

from ratilqr_tpu_torch import (CrossEntropyConfig, ILEQGConfig, MPCDriver,
                               RATiLQRSolver, kernel_check,
                               make_batched_solver)
from ratilqr_tpu_torch.models import cartpole, quadrotor, unicycle
from ratilqr_tpu_torch.ops import _build, riccati_cuda, tile_model
from ratilqr_tpu_torch.solvers import ratilqr, ratilqr_jit
from ratilqr_tpu_torch.utils.profiling import (count_host_syncs,
                                                device_busy)

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
N_REPLANS = 3   # kept small: the cold re-plan alone takes 20-30 s
B_CE = 16_384   # one CE generation at the bank size of the bank's path
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
             "working set in shared memory) at n=12, the quadrotor; one "
             "solve per thread at n <= 4, the unicycle, LQR and the "
             "cartpole"),
    "candidate": ("one solve per team of 16 lanes (two a warp, 8 a block, "
                  "working set in shared memory) at n=12, the quadrotor; one "
                  "solve per thread at n <= 4, the unicycle, LQR and the "
                  "cartpole"),
    "riccati_folded": "one solve per thread"}
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
    kernel's ptxas report, then the same for kernels A at (6, 3) and D at
    n=6, built for those shapes alone."""
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
    for label, kernel in (("B", "step"), ("C", "candidate")):
        for dtype, name in ((torch.float32, "float"),
                            (torch.float64, "double")):
            nbytes, teams, lanes = _build.block_shared_memory(
                kernel, tile_model.QUADROTOR, dtype)
            entry = f"{kernel}_team_kernel"
            for fn, regs, stores, loads, stack in rows:   # demangled or not
                if f"{entry}<{name}," in fn or f"{entry}I{name[0]}" in fn:
                    print(f"kernel {label}, one solve per team (quadrotor, "
                          f"{dtype}): {regs} registers, {stack} B stack "
                          f"frame, {stores} B spill stores, {nbytes} B "
                          f"dynamic shared memory a block of {teams} teams "
                          f"of {lanes} lanes", flush=True)
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


def check_kernels(device):
    """Phase 3: returns the largest float32 difference per kernel."""
    err32 = {}
    cases = [("unicycle", T), ("lqr", 7), ("quadrotor", QUAD_T),
             ("cartpole", CART_T)]
    for dtype in (torch.float32, torch.float64):
        worst = {name: (0.0, 0.0) for name in KERNELS}

        def keep(name, result):
            worst[name] = tuple(map(max, worst[name], result))

        for B in (5, 4_099):
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
            for model, horizon in cases + [("negative_curvature", 7),
                                           (kernel_check.H_FAIL, QUAD_T)]:
                keep("step", kernel_check.check_step(model, horizon, B, dtype,
                                                     device))
        f32 = dtype == torch.float32
        if f32:
            keep("riccati", kernel_check.check_riccati_wide(
                "quadrotor", QUAD_T, B_WIDE, dtype, device))
            kernel_check.clear_caches()
            torch.cuda.empty_cache()
        print(f"kernels vs plain, {dtype}, unicycle T=100, LQR T=7, "
              f"quadrotor T={QUAD_T}, cartpole T={CART_T} (A-D), "
              f"{LINEAR} T={LINEAR_T} (A, D) and the h_fail fixture (A, B), "
              f"B=5 and B=4099"
              + (f", A's slim optimizing pass on the quadrotor at B={B_WIDE}"
                 if f32 else "") + ", "
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


def plain_cpu_parity(cold):
    """Phase 5: 64 lanes of the cold B=16,384 bank on the CPU, plain."""
    idx = torch.linspace(0, B_MAIN - 1, 64).round().long()
    thetas = torch.linspace(0.0, 0.02, B_MAIN, dtype=torch.float32)[idx]
    bank = make_batched_solver(unicycle(N=T, dtype=torch.float32,
                                        device="cpu"),
                               BENCH_CONFIG)
    res = bank(torch.zeros(3), torch.zeros((T, 2)), thetas)
    gpu = {k: getattr(cold, k)[idx.to(cold.value.device)].cpu()
           for k in ("failed", "iterations", "value")}
    assert torch.equal(res.failed, gpu["failed"]), "failed lanes differ"
    assert torch.equal(res.iterations, gpu["iterations"]), (
        f"iterations differ: cpu {res.iterations.tolist()} "
        f"gpu {gpu['iterations'].tolist()}")
    torch.testing.assert_close(gpu["value"], res.value, rtol=1e-3, atol=0)
    rel = float(((gpu["value"] - res.value) / res.value).abs().max())
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


def quadrotor_cpu_parity(device):
    """Phase 6, last: 64 θ of configuration (b), cold, in float64 on the
    card and on the CPU through the plain path."""
    f64 = torch.float64
    idx = torch.linspace(0, B_MAIN - 1, 64).round().long()
    thetas = quad_thetas(B_MAIN, f64)[idx]
    config = MODEL_CONFIGS["b"][0]
    out = []
    for dev in (device, torch.device("cpu")):
        bank = make_batched_solver(quadrotor(N=QUAD_T, dtype=f64, device=dev),
                                   config, device=dev)
        out.append(bank(torch.zeros(12, dtype=f64),
                        torch.zeros((QUAD_T, 4), dtype=f64), thetas))
    gpu = {k: getattr(out[0], k).cpu() for k in ("failed", "iterations",
                                                  "value")}
    cpu = out[1]
    assert not bool(cpu.failed.any()), "float64 quadrotor lanes failed"
    assert torch.equal(cpu.failed, gpu["failed"]), "failed lanes differ"
    assert torch.equal(cpu.iterations, gpu["iterations"]), (
        f"iterations differ: cpu {cpu.iterations.tolist()} "
        f"gpu {gpu['iterations'].tolist()}")
    torch.testing.assert_close(gpu["value"], cpu.value, rtol=1e-3, atol=0)
    rel = float(((gpu["value"] - cpu.value) / cpu.value).abs().max())
    it = cpu.iterations
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


def cartpole_cpu_parity(device):
    """Phase 6, the cartpole against the CPU's plain path: JAX's bench cell
    (x0 = 0, configuration (a), cold and warm at B=16,384; its failure
    pattern on 64 lanes), then 64 lanes of the working cell (b) in
    float64."""
    f32, f64, cpu = torch.float32, torch.float64, torch.device("cpu")
    idx = torch.linspace(0, B_MAIN - 1, 64).round().long()
    thetas = cart_thetas(B_MAIN, f32, device)
    zero_x, zero_u = torch.zeros(4, dtype=f32), torch.zeros((CART_T, 1))
    config = MODEL_CONFIGS["a"][0]
    bank = make_batched_solver(cartpole(N=CART_T, dtype=f32, device=device),
                               config)
    cold = bank(zero_x, zero_u, thetas)
    warm = bank(zero_x, cold.l[0], thetas)
    positive = thetas > 0
    for label, res in (("cold", cold), ("warm", warm)):
        n_failed = int(res.failed.sum())
        at_zero = bool((res.iterations[res.failed] == 0).all())
        print(f"cartpole JAX bench cell (x0 = 0, (a)) {label} B={B_MAIN}: "
              f"{n_failed} failed lanes of {int(positive.sum())} with θ > 0"
              f", all at iteration 0: {at_zero}", flush=True)
    plain = make_batched_solver(cartpole(N=CART_T, dtype=f32, device=cpu),
                                config)(zero_x, zero_u, thetas[idx].cpu())
    for k in ("failed", "iterations"):
        got = getattr(cold, k)[idx.to(device)].cpu()
        assert torch.equal(got, getattr(plain, k)), (
            f"x0 = 0 {k} differ: cpu {getattr(plain, k).tolist()} gpu "
            f"{got.tolist()}")
    print(f"cartpole x0 = 0: 64 lanes' failed ({int(plain.failed.sum())}) "
          "and iterations equal to the CPU plain path's", flush=True)

    config = MODEL_CONFIGS["b"][0]
    out = []
    for dev in (device, cpu):
        bank = make_batched_solver(cartpole(N=CART_T, dtype=f64, device=dev),
                                   config)
        out.append(bank(torch.tensor(CART_X0, dtype=f64),
                        torch.zeros((CART_T, 1), dtype=f64),
                        cart_thetas(B_MAIN, f64)[idx]))
    gpu = {k: getattr(out[0], k).cpu() for k in ("failed", "iterations",
                                                  "value")}
    cpu_res = out[1]
    assert not bool(cpu_res.failed.any()), "float64 cartpole lanes failed"
    assert torch.equal(cpu_res.failed, gpu["failed"]), "failed lanes differ"
    assert torch.equal(cpu_res.iterations, gpu["iterations"]), (
        f"iterations differ: cpu {cpu_res.iterations.tolist()} "
        f"gpu {gpu['iterations'].tolist()}")
    torch.testing.assert_close(gpu["value"], cpu_res.value, rtol=1e-9, atol=0)
    rel = float(((gpu["value"] - cpu_res.value) / cpu_res.value).abs().max())
    it = cpu_res.iterations
    print(f"64 cartpole θ of (b) in float64 on the card vs the plain path on "
          f"the CPU: failed and iterations ({int(it.min())}..{int(it.max())})"
          f" equal, value max rel diff {rel:.3e}", flush=True)


def linear_path(device):
    """Phase 6b: the random linear problem at (6, 3), no tile model, on the
    card in each configuration of ``LINEAR_CONFIGS``, 64 lanes against the
    CPU's plain path in float64; then one bank from numpy inputs.  Returns
    the launch counts per configuration."""
    f64, cpu = torch.float64, torch.device("cpu")
    n, m = kernel_check.linear_dims(LINEAR)
    x0 = np.random.default_rng(0).uniform(-1.0, 1.0, n)
    u0 = np.zeros((LINEAR_T, m))
    thetas = np.linspace(0.0, 0.05, B_LINEAR)
    idx = np.linspace(0, B_LINEAR - 1, 64).round().astype(int)
    prob = {dev: kernel_check.make_problem(LINEAR, LINEAR_T, f64, dev)
            for dev in (device, cpu)}
    counts = {}
    for name, (config, path) in LINEAR_CONFIGS.items():
        _build.reset_launch_counts()
        res, secs = sync_time(lambda: make_batched_solver(prob[device], config)(
            torch.tensor(x0), torch.tensor(u0), torch.tensor(thetas)))
        counts[name] = dict(_build.launch_counts)
        check_result(f"{LINEAR} ({name}) f64 solve", res, B_LINEAR, LINEAR_T,
                     m, secs)
        expect_path(f"{LINEAR} ({name})", counts[name], path)
        plain = make_batched_solver(prob[cpu], config)(x0, u0, thetas[idx])
        for k in ("failed", "iterations"):
            assert torch.equal(getattr(res, k)[idx].cpu(), getattr(plain, k))
        torch.testing.assert_close(res.value[idx].cpu(), plain.value,
                                   rtol=1e-9, atol=0)
        rel = float(((res.value[idx].cpu() - plain.value)
                     / plain.value).abs().max())
        print(f"{LINEAR} ({name}): launch counts {counts[name]}; 64 lanes "
              f"equal to the CPU plain path's, value max rel diff {rel:.3e}",
              flush=True)
    _build.reset_launch_counts()
    res = make_batched_solver(prob[device], ILEQGConfig())(x0, u0, thetas)
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
    """Phase 7: N_REPLANS MPC re-plans through each RAT iLQR entry point;
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
            torch.Generator().manual_seed(0), N_REPLANS)
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
        print(f"RAT iLQR {name}: warm re-plan p50 "
              f"{lat[len(lat) // 2] * 1e3:.1f} ms over re-plans 1-"
              f"{N_REPLANS - 1} (host clock, device synchronized); "
              f"launch counts {counts}", flush=True)
        for kernel in RAT_KERNELS:
            assert counts.get(kernel, 0) > 0, f"{name}: {kernel} never ran"
        for kernel, n in counts.items():
            total[kernel] = total.get(kernel, 0) + n
    return total


def ce_generation(device, name_power):
    """Phase 8: one CE generation of B_CE lanes, timed and profiled, and 64
    of its θ again in float64, on the card and on the CPU (plain path).

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
    again = sync_time(lambda: cost_fn(x0, u0, thetas, KL_BOUND))[1]
    _, wall, busy = device_busy(lambda: cost_fn(x0, u0, thetas, KL_BOUND))
    assert busy > 0, "the profiled CE generation ran nothing on the card"
    print(f"CE generation B={B_CE} (unicycle T={T}, f32): 0 failed, costs "
          f"{float(costs.min()):.6f}..{float(costs.max()):.6f}, iterations "
          f"{int(res.iterations.min())}..{int(res.iterations.max())}; "
          f"first run {secs:.3f} s, then {again:.3f} s (host clock); "
          f"profiled run {wall:.3f} s wall, device busy "
          f"{busy * 1e3:.1f} ms, idle share {1 - busy / wall:.4f} "
          f"({name_power})", flush=True)

    idx = torch.linspace(0, B_CE - 1, 64).round().long()
    th64 = thetas.cpu()[idx].to(f64)
    card_res, cpu = (
        ratilqr.make_cost_fn(rat_problem(dev, f64), RAT_CONFIG).bank(
            torch.zeros(3, dtype=f64, device=dev),
            torch.zeros((T, 2), dtype=f64, device=dev), th64.to(dev))
        for dev in (device, torch.device("cpu")))
    gpu = {k: getattr(card_res, k).cpu() for k in ("failed", "iterations",
                                                    "value")}
    assert not bool(cpu.failed.any()), "float64 CE lanes failed on the CPU"
    assert torch.equal(cpu.failed, gpu["failed"]), "failed lanes differ"
    assert torch.equal(cpu.iterations, gpu["iterations"]), (
        f"iterations differ: cpu {cpu.iterations.tolist()} "
        f"gpu {gpu['iterations'].tolist()}")
    cpu_costs = ratilqr.costs_of(cpu, th64, KL_BOUND)
    gpu_costs = gpu["value"] + KL_BOUND / th64
    torch.testing.assert_close(gpu_costs, cpu_costs, rtol=1e-3, atol=0)
    rel = float(((gpu_costs - cpu_costs) / cpu_costs).abs().max())
    it = cpu.iterations
    print(f"64 CE θ in float64 on the card vs the plain path on the CPU: "
          f"failed and iterations ({int(it.min())}..{int(it.max())}) equal, "
          f"cost max rel diff {rel:.3e}", flush=True)


def timings(device, name_power):
    """Phase 9: returns {(model, B): {kernel: record}} with each kernel's
    wrapper, launch-alone and plain times and its bound."""
    f32 = torch.float32
    result = {}
    # The kernel record's widths, and both for the cartpole and for kernels
    # A, B and C on the quadrotor; the unicycle at B=16,384 and kernel D on
    # the quadrotor at 262,144 are left out to keep the run short (PERF.md
    # keeps their last numbers).
    every = ("riccati", "step", "candidate", "riccati_folded")
    for model, horizon, B, kernels in (
            ("unicycle", T, B_WIDE, every),
            ("quadrotor", QUAD_T, B_MAIN, every),
            ("quadrotor", QUAD_T, B_WIDE, ("riccati", "step", "candidate")),
            ("cartpole", CART_T, B_MAIN, every),
            ("cartpole", CART_T, B_WIDE, every)):
        n, m = MODEL_DIMS[model]
        times = kernel_check.kernel_timings(model, horizon, B, f32, device,
                                            kernels)
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
                  f"the plain version of 3, CUDA events; {name_power})",
                  flush=True)
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
    ``"cartpole"``, the unicycle path at B=262,144 under ``"unicycle"``
    and, for kernels A, B and C, the quadrotor at B=262,144 under
    ``"quadrotor_wide"``."""
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
                "at": f"cartpole n=4 m=1 T={CART_T} B={B_MAIN} f32"}})
        wide = times.get(("quadrotor", B_WIDE), {}).get(name)
        if wide is not None:
            rows[-1]["quadrotor_wide"] = {
                **wide, "library_ms": None,
                "at": f"quadrotor n=12 m=4 T={QUAD_T} B={B_WIDE} f32"}
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
    t_start = time.perf_counter()

    def phase(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.empty_cache()
        print(f"phase {label}: {time.perf_counter() - t0:.1f} s", flush=True)
        return out

    phase("build", build)
    err32 = phase("kernels vs plain", check_kernels, device)
    cold, bank_counts = phase("unicycle bank", main_path, device)
    phase("unicycle CPU parity", plain_cpu_parity, cold)
    del cold
    quad_counts = phase("quadrotor bank", quadrotor_path, device)
    phase("quadrotor f64 CPU parity", quadrotor_cpu_parity, device)
    cart_counts = phase("cartpole bank", cartpole_path, device)
    phase("cartpole CPU parity", cartpole_cpu_parity, device)
    linear_counts = phase("any problem", linear_path, device)
    rat_counts = phase("RAT iLQR MPC", rat_mpc, device)
    phase("CE generation", ce_generation, device, name_power)
    times = phase("timings", timings, device, name_power)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s after the "
          f"device check ({name_power})", flush=True)

    print(json.dumps(kernel_record(
        err32, quad_counts, cart_counts,
        {"unicycle_bank": bank_counts, "rat_ilqr": rat_counts,
         **{f"{LINEAR}_{k}": c for k, c in linear_counts.items()}}, times)),
        flush=True)
    print(name_power, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
