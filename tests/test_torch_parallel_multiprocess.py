"""The port's distributed layer on real process groups: 2 and 4 gloo ranks
on the CPU, spawned once for the module (float64).

Every sharded function must return on every rank what its unsharded twin
returns on the whole sample axis (rtol 1e-12): the θ-bank (an axis that
divides over the ranks and one that does not), the PETS solve through
both elite paths, ``compute_cost_shard_map`` with the whole bank's noise
injected, and the seed-sharded fleet with its per-seed plan states.  A
sample axis that ``shard_map`` and the fleet cannot split must raise
"divide evenly".

Each rank is a spawned process on one torch thread with a time limit; the
two groups run side by side, and rank 0 also computes the unsharded
references.  Results come back to the test process as numpy arrays.
"""
import multiprocessing
import queue
import socket
import traceback

import numpy as np
import pytest

torch = pytest.importorskip("torch")

WORLDS = (2, 4)
RANK_TIMEOUT_S = 300


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _numpy(tree):
    """Tensors of a result tree as numpy arrays (lists, tuples, dicts and
    named tuples kept as plain containers)."""
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy(x) for x in tree]
    return tree


def _checks(world: int, rank: int, mesh) -> dict:
    """Every case on this rank: ``{name: (sharded, unsharded)}``, the
    unsharded side on rank 0 only (``None`` elsewhere)."""
    from ratilqr_tpu_torch.config import (CrossEntropyConfig, ILEQGConfig,
                                          PETSConfig)
    from ratilqr_tpu_torch.models import (gmm_integrator, lqr_problem,
                                          nonlinear_toy)
    from ratilqr_tpu_torch.mpc_episode import (make_fleet_runner,
                                               make_gaussian_simulator,
                                               make_ileqg_plan)
    from ratilqr_tpu_torch.parallel import (compute_cost_shard_map,
                                            make_sharded_fleet_runner,
                                            make_sharded_pets_solve,
                                            make_sharded_theta_cost_fn)
    from ratilqr_tpu_torch.problems import RiskSensitiveProblem
    from ratilqr_tpu_torch.solvers import pets, ratilqr

    f64 = torch.float64
    out = {}

    def case(name, sharded, unsharded):
        out[name] = (sharded(), unsharded() if rank == 0 else None)

    # The θ-bank: the nonlinear toy at 8 θ and at 7 (a padded last block),
    # and a fixture with breakdown (Inf) lanes.
    toy = nonlinear_toy(N=10, device="cpu")
    ce = CrossEntropyConfig(num_samples=8)
    x0, u0 = torch.zeros(2, dtype=f64), 0.1 * torch.ones((10, 2), dtype=f64)
    for K in (8, 7):
        th = torch.linspace(0.05, 0.6, K, dtype=f64)
        case(f"theta_{K}", lambda: make_sharded_theta_cost_fn(
            toy, ce, mesh)(x0, u0, th, 1.0),
            lambda: ratilqr.make_cost_fn(toy, ce)(x0, u0, th, 1.0))
    wide = RiskSensitiveProblem(
        f=lambda x, u: x + u, c=lambda k, x, u: x @ x + u @ u,
        h=lambda x: x @ x, W=lambda k: 1e3 * torch.eye(2, dtype=f64), N=6)
    ce3 = CrossEntropyConfig(num_samples=8, ileqg=ILEQGConfig(iter_max=3))
    th = torch.cat([torch.linspace(1e-6, 1e-4, 4, dtype=f64),
                    torch.linspace(1.0, 100.0, 4, dtype=f64)])
    args = (torch.ones(2, dtype=f64), torch.zeros((6, 2), dtype=f64), th,
            1.0)
    case("theta_breakdown",
         lambda: make_sharded_theta_cost_fn(wide, ce3, mesh)(*args),
         lambda: ratilqr.make_cost_fn(wide, ce3)(*args))

    # PETS on the GMM world (its cost depends on the noise), both elite
    # paths, at K = 16 and at K = 10 (4 ranks: a padded last block).
    gmm = gmm_integrator(N=8, device="cpu")
    x0 = torch.tensor([0.5, -0.5], dtype=f64)
    for K in (16, 10):
        cfg = PETSConfig(num_control_samples=K, num_trajectory_samples=3,
                         num_elite=4, iter_max=3)
        state = pets.init_state(torch.zeros((8, 2), dtype=f64),
                                torch.eye(2, dtype=f64).expand(8, 2, 2))
        for shard_elites in (False, True):
            case(f"pets_{K}_{'shard' if shard_elites else 'gather'}",
                 lambda: make_sharded_pets_solve(
                     gmm, cfg, mesh, True, shard_elites)(
                     x0, state, torch.Generator().manual_seed(5))[:2],
                 lambda: pets.solve(gmm, cfg, x0, state,
                                    torch.Generator().manual_seed(5),
                                    True)[:2])

    # compute_cost_shard_map with the whole bank's noise injected.
    cfg = PETSConfig(num_control_samples=4 * world, num_trajectory_samples=3)
    g = torch.Generator().manual_seed(6)
    us = torch.randn((4 * world, 8, 2), generator=g, dtype=f64)
    bank = torch.zeros((12 * world, 2), dtype=f64)
    noise = [gmm.draw_noise(g, bank, True) for _ in range(8)]
    case("shard_map_noise", lambda: compute_cost_shard_map(
        gmm, cfg, mesh, x0, us, None, True, noise),
        lambda: pets.compute_cost(gmm, cfg, x0, us, None, True, noise))
    # ... and from the generator: deterministic for one generator state
    # (both calls are collectives, so every rank makes both).
    out["shard_map_generator"] = tuple(compute_cost_shard_map(
        gmm, cfg, mesh, x0, us, torch.Generator().manual_seed(7), True)
        for _ in range(2))

    # The fleet: LQR, 8 seeds x 4 steps, with a per-seed list plan state
    # (as RAT iLQR++'s plan step keeps one).
    lqr = lqr_problem(N=6, noise=1e-3, device="cpu")
    ileqg_plan = make_ileqg_plan(lqr, ILEQGConfig(iter_max=15), 0.0)

    def plan(state, x, u_warm, generators):
        _, res = ileqg_plan((), x, u_warm, generators)
        return [{"x": x[s], "value": res.value[s]}
                for s in range(x.shape[0])], res

    fleet_args = (plan, make_gaussian_simulator(lqr), 4, lqr.c)
    x0, u0 = torch.tensor([1.0, -1.0], dtype=f64), torch.zeros((6, 2),
                                                               dtype=f64)

    def gens():
        return [torch.Generator().manual_seed(9 + s) for s in range(8)]

    case("fleet", lambda: tuple(make_sharded_fleet_runner(mesh, *fleet_args)(
        x0, u0, gens(), ())),
        lambda: tuple(make_fleet_runner(*fleet_args)(x0, u0, gens(), ())))

    # Sample axes that do not divide over the ranks.
    errors = []
    for fn in (lambda: compute_cost_shard_map(
                   gmm, cfg, mesh, x0, us[:2 * world + 1], None, True),
               lambda: make_sharded_fleet_runner(mesh, *fleet_args)(
                   x0, u0, gens()[:world + 1], ())):
        try:
            fn()
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = (errors, None)
    return out


def _rank_main(world: int, rank: int, port: int, results) -> None:
    """One rank: join the group, run every case, report to the parent."""
    try:
        torch.set_num_threads(1)
        from ratilqr_tpu_torch.parallel import (distributed_initialize,
                                                make_mesh)
        distributed_initialize(device="cpu",
                               init_method=f"tcp://localhost:{port}",
                               rank=rank, world_size=world)
        out = _checks(world, rank, make_mesh(device="cpu"))
        import torch.distributed as dist
        dist.destroy_process_group()
        results.put((world, rank, _numpy(out), None))
    except BaseException:
        results.put((world, rank, None, traceback.format_exc()))


@pytest.fixture(scope="module")
def runs():
    """``{world: [rank 0's results, rank 1's, ...]}`` from one spawn of
    every group, the groups side by side."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(w, r, port, results))
             for w, port in ((w, _free_port()) for w in WORLDS)
             for r in range(w)]
    for p in procs:
        p.start()
    got, errors = {}, []
    try:
        for _ in procs:
            world, rank, out, err = results.get(timeout=RANK_TIMEOUT_S)
            if err is not None:
                errors.append(f"world {world} rank {rank}:\n{err}")
            got.setdefault(world, {})[rank] = out
    except queue.Empty:
        errors.append(f"a rank gave no result within {RANK_TIMEOUT_S} s")
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join()
    assert not errors, "\n".join(errors)
    return {w: [got[w][r] for r in range(w)] for w in WORLDS}


def _assert_close(got, want, tag):
    if isinstance(got, (list, tuple)):
        assert len(got) == len(want), tag
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_close(a, b, f"{tag}[{i}]")
    elif isinstance(got, dict):
        assert sorted(got) == sorted(want), tag
        for k in got:
            _assert_close(got[k], want[k], f"{tag}[{k}]")
    elif isinstance(got, np.ndarray):
        assert got.shape == np.shape(want), tag
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0,
                                   err_msg=tag)
    else:
        assert got == want, tag


CASES = ("theta_8", "theta_7", "theta_breakdown", "pets_16_gather",
         "pets_16_shard", "pets_10_gather", "pets_10_shard",
         "shard_map_noise", "shard_map_generator", "fleet")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", CASES)
def test_sharded_equals_unsharded_on_every_rank(runs, world, name):
    """Rank 0's unsharded run against every rank's sharded result."""
    ranks = runs[world]
    sharded, unsharded = ranks[0][name]
    _assert_close(sharded, unsharded, f"{name}, rank 0 of {world}")
    for r in range(1, world):
        _assert_close(ranks[r][name][0], sharded, f"{name}, rank {r}")


def test_fixtures_exercise_what_they_claim(runs):
    """The breakdown fixture has Inf and finite lanes, the padded PETS
    case really pads at 4 ranks, and the fleet's plan state is per seed."""
    theta = runs[2][0]["theta_breakdown"][1]
    assert np.isinf(theta).any() and np.isfinite(theta).any()
    assert 10 % 4 != 0 and 7 % 2 != 0
    fleet = runs[4][0]["fleet"][0]
    assert np.shape(fleet[0]) == (8, 5, 2) and len(fleet[5]) == 8


@pytest.mark.parametrize("world", WORLDS)
def test_indivisible_sample_axes_raise(runs, world):
    errors, _ = runs[world][0]["errors"]
    assert len(errors) == 2
    for e in errors:
        assert e is not None and "divide evenly" in e, e
