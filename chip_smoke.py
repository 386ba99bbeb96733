#!/usr/bin/env python3
"""Drive the PyTorch port (the iLEQG solver bank, RAT iLQR and the MPC
driver) on one CUDA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.

Phases (each prints a line and raises on failure):
  1. device: the card's name and power limit; exits non-zero without CUDA;
  2. build: compiles the CUDA kernels from ratilqr_tpu_torch/csrc;
  3. every kernel against its plain PyTorch version on the card, float32
     and float64, at the unicycle T=100 and LQR T=7 with B=5 and B=4,099
     (kernel D with a shared and a per-lane noise model);
  4. the bank's path at full width — the warm-started unicycle bank
     (T=100, bench configuration) cold and warm at B=16,384, warm at
     B=262,144, and the default configuration at B=1,024 — with the
     kernels' launch counts read around it;
  5. 64 lanes of the B=16,384 bank again on the CPU through the plain path;
  6. the RAT iLQR path: ``MPCDriver`` re-planning the unicycle (T=100,
     f32) five times through ``RATiLQRSolver`` and through the single-call
     ``ratilqr_jit.solve``, on the folded candidate evaluation (kernel D)
     and the fused step (kernel B), with the launch counts read around
     each path;
  7. one CE generation at width (16,384 θ samples), timed and profiled
     (device idle share), and 64 of its θ again in float64 on the card and
     on the CPU through the plain path;
  8. timings: each kernel against its plain version, and warm solves/s.
The last line is the JSON device record.
"""
import json
import subprocess
import sys
import time

import numpy as np
import torch

from ratilqr_tpu_torch import (CrossEntropyConfig, ILEQGConfig, MPCDriver,
                               RATiLQRSolver, kernel_check,
                               make_batched_solver)
from ratilqr_tpu_torch.models import unicycle
from ratilqr_tpu_torch.ops import _build
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
# RAT iLQR: examples/mpc_unicycle.py:56-57 at the bench horizon, on the
# folded candidate evaluation with the chunked ε ladder.
RAT_CONFIG = CrossEntropyConfig(
    num_samples=10, num_elite=3, iter_max=5, mu_init=0.005, sigma_init=0.01,
    ileqg=ILEQGConfig(iter_max=30, adaptive_eps_init=True, eps_history_cap=0,
                      fused_step_optimize=True, fold_candidate_eval=True,
                      ls_chunk=4))
KL_BOUND = 0.05
N_REPLANS = 5
B_CE = 16_384   # one CE generation at the bank size of the bank's path
KERNELS = {   # name: (source, the TPU kernel it replaces)
    "riccati": ("ratilqr_tpu_torch/csrc/riccati.cu",
                "ratilqr_tpu/ops/riccati_pallas.py:193"),
    "step": ("ratilqr_tpu_torch/csrc/step.cu",
             "ratilqr_tpu/ops/step_pallas.py:81"),
    "candidate": ("ratilqr_tpu_torch/csrc/candidate.cu",
                  "ratilqr_tpu/ops/candidate_pallas.py:81"),
    "riccati_folded": ("ratilqr_tpu_torch/csrc/riccati_folded.cu",
                       "ratilqr_tpu/ops/riccati_pallas.py:581"),
}
BANK_KERNELS = ("riccati", "step", "candidate")   # phase 4's path
RAT_KERNELS = ("step", "riccati_folded")           # phase 6's path


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


def check_kernels(device):
    """Phase 3: returns the largest float32 difference per kernel."""
    err32 = {}
    cases = [("unicycle", T), ("lqr", 7)]
    for dtype in (torch.float32, torch.float64):
        worst = {name: (0.0, 0.0) for name in KERNELS}

        def keep(name, result):
            worst[name] = tuple(map(max, worst[name], result))

        for B in (5, 4_099):
            for model, horizon in cases:
                for variant in kernel_check.RICCATI_VARIANTS:
                    keep("riccati", kernel_check.check_riccati(
                        model, horizon, B, dtype, device, **variant))
                keep("candidate", kernel_check.check_candidate(
                    model, horizon, B, dtype, device))
                for shared_w in (True, False):
                    keep("riccati_folded", kernel_check.check_riccati_folded(
                        model, horizon, B, dtype, device, shared_w))
            for model, horizon in cases + [("negative_curvature", 7)]:
                keep("step", kernel_check.check_step(model, horizon, B, dtype,
                                                     device))
        f32 = dtype == torch.float32
        print(f"kernels vs plain, {dtype}, unicycle T=100 and LQR T=7, "
              f"B=5 and B=4099, {len(kernel_check.RICCATI_VARIANTS)} riccati "
              "variants: agree; max |kernel - plain|"
              + (" (plain's own error vs float64)" if f32 else "") + ": "
              + ", ".join(f"{k} {e:.3e}" + (f" ({p:.3e})" if f32 else "")
                          for k, (e, p) in worst.items()), flush=True)
        if f32:
            err32 = {k: e for k, (e, _) in worst.items()}
    m_fail, _ = kernel_check.expect_fail_pattern("unicycle", T, 4_099,
                                                 torch.float32, device)
    expect = int(np.sum(np.resize(kernel_check.THETA_MIX, 4_099) == 1e6))
    assert m_fail == expect, f"{m_fail} m_fail lanes, expected {expect}"
    _, h_fail = kernel_check.expect_fail_pattern("negative_curvature", 7, 5,
                                                 torch.float32, device)
    assert h_fail > 0, "the negative-curvature fixture must fail H"
    print(f"fail latching: {m_fail} θ=1e6 lanes latch m_fail; "
          f"{h_fail}/5 negative-curvature lanes latch h_fail", flush=True)
    return err32


def main_path(device):
    """Phase 4: the bank at full width; returns (results, launch counts)."""
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
    default_bank = make_batched_solver(prob, ILEQGConfig(), device=device)
    dflt, t_dflt = sync_time(lambda: default_bank(
        x0, torch.zeros((T, 2), dtype=f32, device=device),
        thetas[:: B_MAIN // B_DEFAULT]))
    counts = dict(_build.launch_counts)

    for name, res, B, secs in (("cold", cold, B_MAIN, t_cold),
                               ("warm", warm, B_MAIN, t_warm),
                               ("warm", wide, B_WIDE, t_wide),
                               ("default-config cold", dflt, B_DEFAULT,
                                t_dflt)):
        assert res.value.shape == (B,) and res.l.shape == (B, T, 2)
        n_failed = int(res.failed.sum())
        assert n_failed == 0, f"{name} B={B}: {n_failed} failed lanes"
        assert bool(torch.isfinite(res.value).all()), f"{name} B={B}"
        it = res.iterations
        print(f"main path {name} solve B={B}: 0 failed, values "
              f"{float(res.value.min()):.6f}..{float(res.value.max()):.6f}, "
              f"iterations {int(it.min())}..{int(it.max())}, "
              f"{secs:.3f} s", flush=True)
    for name in BANK_KERNELS:
        assert counts.get(name, 0) > 0, f"{name} kernel never launched"
    print(f"bank path launch counts: {counts}", flush=True)
    return cold, counts


def plain_cpu_parity(cold):
    """Phase 5: 64 lanes of the cold B=16,384 bank on the CPU, plain."""
    idx = torch.linspace(0, B_MAIN - 1, 64).round().long()
    thetas = torch.linspace(0.0, 0.02, B_MAIN, dtype=torch.float32)[idx]
    bank = make_batched_solver(unicycle(N=T, dtype=torch.float32),
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


def rat_problem(device, dtype=torch.float32):
    return unicycle(N=T, noise=2e-3, dtype=dtype, device=device,
                    analytic_jacobians=True)


def rat_mpc(device):
    """Phase 6: five MPC re-plans through each RAT iLQR entry point;
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
    """Phase 7: one CE generation of B_CE lanes, timed and profiled, and 64
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
    runs = sorted(sync_time(lambda: cost_fn(x0, u0, thetas, KL_BOUND))[1]
                  for _ in range(3))
    _, wall, busy = device_busy(lambda: cost_fn(x0, u0, thetas, KL_BOUND))
    assert busy > 0, "the profiled CE generation ran nothing on the card"
    print(f"CE generation B={B_CE} (unicycle T={T}, f32): 0 failed, costs "
          f"{float(costs.min()):.6f}..{float(costs.max()):.6f}, iterations "
          f"{int(res.iterations.min())}..{int(res.iterations.max())}; "
          f"first run {secs:.3f} s, then {runs[1]:.3f} s (median of 3, host "
          f"clock); profiled run {wall:.3f} s wall, device busy "
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
    """Phase 8: returns {kernel: (ms, plain ms)} at B_WIDE."""
    f32 = torch.float32
    result = {}
    for B in (B_MAIN, B_WIDE):
        times = kernel_check.kernel_timings(T, B, f32, device)
        launch_ms, _ = times.pop("riccati_folded_launch")
        for kernel, (ms, plain) in times.items():
            print(f"time {kernel} T={T} B={B} f32: wrapper {ms:.3f} ms, "
                  f"plain {plain:.3f} ms (median of 5, CUDA events; "
                  f"{name_power})", flush=True)
            if B == B_WIDE:
                result[kernel] = (ms, plain)
        print(f"time riccati_folded T={T} B={B} f32: launch alone on "
              f"lane-minor inputs {launch_ms:.3f} ms (median of 5, CUDA "
              f"events; {name_power})", flush=True)
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

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {lib_path.name} "
          f"({lib_path.parent.name})", flush=True)
    for line in (lib_path.parent / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas" + line.split("ptxas", 1)[-1], flush=True)

    err32 = check_kernels(device)
    cold, counts = main_path(device)
    plain_cpu_parity(cold)
    rat_counts = rat_mpc(device)
    counts["riccati_folded"] = rat_counts["riccati_folded"]
    ce_generation(device, name_power)
    times = timings(device, name_power)

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name], "max_abs_err": err32[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name, (src, rep) in KERNELS.items()]}), flush=True)
    print(name_power, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
