"""The port's distributed layer (``ratilqr_tpu_torch/parallel``) on an
in-process gloo group of world size 1 (CPU, float64): the ten cases of
tests/test_parallel.py, each sharded function against its unsharded twin
in the port, and against the JAX package's sharded functions on the
conftest's 8 virtual devices.

torch's and JAX's random streams differ, so the JAX comparisons use
draw-free quantities (the θ-bank), a cost that ignores the trajectory
noise (the PETS fixture's ``Σ|u| + 1``) with injected control draws, or
an injected noise table (the fleet).  The rule that a sample axis divides
evenly over the ranks is checked against a mesh that reports 8 ranks; the
spawned 2- and 4-rank groups of tests/test_torch_parallel_multiprocess.py
check it on real groups.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

import ratilqr_tpu.parallel as jpar  # noqa: E402
from ratilqr_tpu import CrossEntropyConfig as JCE  # noqa: E402
from ratilqr_tpu import ILEQGConfig as JIL  # noqa: E402
from ratilqr_tpu import PETSConfig as JPETS  # noqa: E402
from ratilqr_tpu import mpc_episode as jme  # noqa: E402
from ratilqr_tpu.models import lqr_problem as jlqr  # noqa: E402
from ratilqr_tpu.models import nonlinear_toy as jtoy  # noqa: E402
from ratilqr_tpu.problems import GenerativeProblem as JGen  # noqa: E402
from ratilqr_tpu.solvers import pets as jpets  # noqa: E402
from ratilqr_tpu_torch import parallel  # noqa: E402
from ratilqr_tpu_torch.config import (CrossEntropyConfig,  # noqa: E402
                                      ILEQGConfig, PETSConfig)
from ratilqr_tpu_torch.models import lqr_problem, nonlinear_toy  # noqa: E402
from ratilqr_tpu_torch.mpc_episode import (  # noqa: E402
    make_fleet_runner, make_gaussian_simulator, make_ileqg_plan)
from ratilqr_tpu_torch.parallel import (  # noqa: E402
    compute_cost_shard_map, make_mesh, make_sharded_fleet_runner,
    make_sharded_pets_solve, make_sharded_theta_cost_fn,
    sharded_elite_selection)
from ratilqr_tpu_torch.problems import RiskSensitiveProblem  # noqa: E402
from ratilqr_tpu_torch.solvers import pets, ratilqr  # noqa: E402
from ratilqr_tpu_torch.tests_support import (  # noqa: E402,F401
    pets_uniform_problem)

F64 = torch.float64
N = 20   # the PETS fixture's horizon


@pytest.fixture(autouse=True, scope="module")
def mesh():
    """A gloo group of one rank in this process, its 1-D mesh, one torch
    thread; the group is destroyed with the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    device = parallel.distributed_initialize(
        device="cpu", store=dist.HashStore(), rank=0, world_size=1)
    assert device == torch.device("cpu")
    yield make_mesh(device="cpu")
    dist.destroy_process_group()
    torch.set_num_threads(n)


class EightRanks:
    """A mesh that reports 8 ranks (rank 0): enough for the divisibility
    rules, which raise before any collective."""

    def size(self):
        return 8

    def get_local_rank(self):
        return 0


def test_mesh_spans_the_world(mesh):
    assert mesh.size() == 1 and mesh.mesh_dim_names == ("samples",)
    assert parallel.SAMPLE_AXIS == jpar.SAMPLE_AXIS == "samples"
    assert (sorted(n for n in dir(parallel) if not n.startswith("_")
                   and n not in ("mesh", "sharded"))
            == sorted(n for n in dir(jpar) if not n.startswith("_")
                      and n not in ("mesh", "sharded")))
    from torch.distributed.tensor import distribute_tensor
    x = torch.arange(12.0, dtype=F64).reshape(6, 2)
    for sharding in (parallel.sample_sharding(mesh),
                     parallel.replicated(mesh)):
        d = distribute_tensor(x, *sharding)
        assert torch.equal(d.to_local(), x)
        assert torch.equal(d.full_tensor(), x)
    with pytest.raises(ValueError, match="mesh spans every rank"):
        make_mesh(2, device="cpu")


def _toy_inputs():
    return (np.zeros(2), 0.1 * np.ones((10, 2)), np.linspace(0.05, 0.6, 8))


def test_sharded_theta_bank_matches_unsharded_and_jax(mesh):
    """Sharded θ-bank ≡ the port's unsharded bank (bit for bit) ≡ JAX's
    sharded bank on 8 devices (rtol 1e-10), nonlinear toy, 8 θ."""
    x0, u0, thetas = _toy_inputs()
    prob = nonlinear_toy(N=10, device="cpu")
    config = CrossEntropyConfig(num_samples=8)
    args = (torch.tensor(x0), torch.tensor(u0), torch.tensor(thetas), 1.0)
    got = make_sharded_theta_cost_fn(prob, config, mesh)(*args)
    assert torch.equal(got, ratilqr.make_cost_fn(prob, config)(*args))
    want = jpar.make_sharded_theta_cost_fn(
        jtoy(N=10), JCE(num_samples=8), jpar.make_mesh())(
        jnp.asarray(x0), jnp.asarray(u0), jnp.asarray(thetas), 1.0)
    assert jpar.make_mesh().shape["samples"] == 8
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10)


def test_sharded_theta_bank_masks_nonfinite_lanes(mesh):
    """Sharded ≡ unsharded including non-finite lanes: breakdown lanes are
    Inf, NaN-objective lanes (NaN dynamics, no failure flag) are masked
    to Inf in both paths."""
    prob = RiskSensitiveProblem(
        f=lambda x, u: x + u, c=lambda k, x, u: x @ x + u @ u,
        h=lambda x: x @ x, W=lambda k: 1e3 * torch.eye(2, dtype=F64), N=6)
    config = CrossEntropyConfig(num_samples=8, ileqg=ILEQGConfig(iter_max=3))
    x0, u0 = torch.ones(2, dtype=F64), torch.zeros((6, 2), dtype=F64)
    thetas = torch.cat([torch.linspace(1e-6, 1e-4, 4, dtype=F64),
                        torch.linspace(1.0, 100.0, 4, dtype=F64)])
    c_sharded = make_sharded_theta_cost_fn(prob, config, mesh)(
        x0, u0, thetas, 1.0)
    c_plain = ratilqr.make_cost_fn(prob, config)(x0, u0, thetas, 1.0)
    assert bool(torch.isinf(c_plain).any()), "fixture needs breakdown lanes"
    assert bool(torch.isfinite(c_plain).any()), "fixture needs feasible lanes"
    assert not bool(torch.isnan(c_sharded).any())
    assert torch.equal(c_sharded, c_plain)

    nan_prob = RiskSensitiveProblem(
        f=lambda x, u: torch.sqrt(x - 100.0) + u,   # sqrt of negative: NaN
        c=lambda k, x, u: x @ x + u @ u, h=lambda x: x @ x,
        W=lambda k: 0.1 * torch.eye(2, dtype=F64), N=6)
    th2 = torch.linspace(0.01, 0.1, 8, dtype=F64)
    x0 = torch.zeros(2, dtype=F64)
    cn = make_sharded_theta_cost_fn(nan_prob, config, mesh)(x0, u0, th2, 1.0)
    cn_plain = ratilqr.make_cost_fn(nan_prob, config)(x0, u0, th2, 1.0)
    assert bool(torch.isinf(cn).all()) and bool(torch.isinf(cn_plain).all())


def jax_uniform_problem():
    """``ratilqr_tpu.tests_support.pets_uniform_problem``."""
    def f_stochastic(x, u, key, use_true_model=False):
        return x + u + jax.random.uniform(key, x.shape, dtype=x.dtype)

    return JGen(f_stochastic=f_stochastic,
                c=lambda k, x, u: jnp.sum(jnp.abs(u)),
                h=lambda x: jnp.asarray(1.0, x.dtype), N=N)


def test_shard_map_pets_cost_shapes_and_determinism(mesh,
                                                    pets_uniform_problem):
    config = PETSConfig(num_control_samples=16, num_trajectory_samples=3)
    us = np.random.default_rng(0).normal(size=(16, N, 2))
    x0 = torch.zeros(2, dtype=F64)
    c1, c2 = (compute_cost_shard_map(
        pets_uniform_problem, config, mesh, x0, torch.tensor(us),
        torch.Generator().manual_seed(1)) for _ in range(2))
    assert c1.shape == (16,) and torch.equal(c1, c2)
    # The cost ignores the noise: Σ|u| + 1 exactly, as JAX's under any key.
    expected = np.abs(us).sum((1, 2)) + 1.0
    np.testing.assert_allclose(c1.numpy(), expected, rtol=1e-12)
    want = jpar.compute_cost_shard_map(
        jax_uniform_problem(), JPETS(num_control_samples=16,
                                     num_trajectory_samples=3),
        jpar.make_mesh(), jnp.zeros(2), jnp.asarray(us), jax.random.key(1))
    np.testing.assert_allclose(c1.numpy(), np.asarray(want), rtol=1e-12)


def test_shard_map_pets_cost_injected_noise_matches_compute_cost(mesh):
    """With the whole bank's noise injected, the sharded cost equals
    ``pets.compute_cost`` on the same draws bit for bit (the gmm world,
    whose cost depends on the noise)."""
    from ratilqr_tpu_torch.models import gmm_integrator
    prob = gmm_integrator(N=6, device="cpu")
    config = PETSConfig(num_control_samples=8, num_trajectory_samples=3)
    g = torch.Generator().manual_seed(4)
    us = torch.randn((8, 6, 2), generator=g, dtype=F64)
    bank = torch.zeros((24, 2), dtype=F64)
    noise = [prob.draw_noise(g, bank, True) for _ in range(6)]
    x0 = torch.tensor([0.5, -0.5], dtype=F64)
    got = compute_cost_shard_map(prob, config, mesh, x0, us, None, True,
                                 noise)
    assert torch.equal(got, pets.compute_cost(prob, config, x0, us, None,
                                              True, noise))


def _pets_setup():
    config = PETSConfig(num_control_samples=16, num_trajectory_samples=4,
                        num_elite=4, iter_max=3)
    mu, sigma = np.zeros((N, 2)), np.repeat(np.eye(2)[None], N, 0)
    return config, mu, sigma


@pytest.mark.parametrize("shard_elites", [False, True])
def test_sharded_pets_solve_matches_unsharded(mesh, pets_uniform_problem,
                                              shard_elites):
    """Same generator state → the sharded solve reproduces ``pets.solve``
    bit for bit (same control draws, same noise stream, same elites)."""
    config, mu, sigma = _pets_setup()
    state = pets.init_state(torch.tensor(mu), torch.tensor(sigma))
    x0 = torch.zeros(2, dtype=F64)
    out = make_sharded_pets_solve(pets_uniform_problem, config, mesh,
                                  shard_elites=shard_elites)(
        x0, state, torch.Generator().manual_seed(42))
    ref = pets.solve(pets_uniform_problem, config, x0, state,
                     torch.Generator().manual_seed(42))
    assert torch.equal(out.mu, ref.mu) and torch.equal(out.sigma, ref.sigma)
    assert out.iter_current == ref.iter_current == 3


def test_sharded_pets_solve_matches_jax(mesh, monkeypatch,
                                        pets_uniform_problem):
    """The sharded solve, both elite paths, against JAX's on 8 devices
    with the same control draws (a fixed z table in both packages: JAX's
    CEM is one ``lax.scan``, so its patched sampler is traced once), μ and
    Σ at rtol 1e-12."""
    config, mu, sigma = _pets_setup()
    z = np.random.default_rng(3).normal(size=(16, N, 2))

    def jax_sampler(state, key, num_samples):
        chol = jnp.linalg.cholesky(state.sigma)
        return state.mu[None] + jnp.einsum("nij,knj->kni", chol,
                                           jnp.asarray(z))

    def torch_sampler(state, generator, num_samples, z_=None):
        return sample(state, generator, num_samples, torch.tensor(z))

    sample = pets.sample_control_sequences
    monkeypatch.setattr(jpets, "sample_control_sequences", jax_sampler)
    monkeypatch.setattr(pets, "sample_control_sequences", torch_sampler)
    jcfg = JPETS(num_control_samples=16, num_trajectory_samples=4,
                 num_elite=4, iter_max=3)
    for shard_elites in (False, True):
        got = make_sharded_pets_solve(pets_uniform_problem, config, mesh,
                                      shard_elites=shard_elites)(
            torch.zeros(2, dtype=F64),
            pets.init_state(torch.tensor(mu), torch.tensor(sigma)),
            torch.Generator().manual_seed(0))
        want = jpar.make_sharded_pets_solve(
            jax_uniform_problem(), jcfg, jpar.make_mesh(),
            shard_elites=shard_elites)(
            jnp.zeros(2), jpets.init_state(jnp.asarray(mu),
                                           jnp.asarray(sigma)),
            jax.random.key(0))
        np.testing.assert_allclose(got.mu.numpy(), np.asarray(want.mu),
                                   rtol=1e-12, atol=1e-15)
        np.testing.assert_allclose(got.sigma.numpy(),
                                   np.asarray(want.sigma), rtol=1e-12,
                                   atol=1e-15)


def test_shard_map_rejects_indivisible_batch(pets_uniform_problem):
    config = PETSConfig(num_control_samples=10)
    with pytest.raises(ValueError, match="divide evenly"):
        compute_cost_shard_map(pets_uniform_problem, config, EightRanks(),
                               torch.zeros(2, dtype=F64),
                               torch.zeros((10, N, 2), dtype=F64),
                               torch.Generator().manual_seed(0))


@pytest.mark.parametrize("ties", [False, True])
def test_sharded_elite_selection_matches_global_topk(mesh, ties):
    """The merged top-k equals ``pets.get_elite_samples`` and JAX's
    ``sharded_elite_selection`` on the same bank; with ties (costs
    rounded to a few values) the lower index wins in both packages."""
    K, T, m, ne = 64, 5, 2, 7
    rng = np.random.default_rng(9)
    us = rng.normal(size=(K, T, m))
    costs = rng.normal(size=K)
    if ties:
        costs = np.round(costs)
    got = sharded_elite_selection(mesh, torch.tensor(us),
                                  torch.tensor(costs), ne)
    ref, _ = pets.get_elite_samples(torch.tensor(us), torch.tensor(costs),
                                    ne)
    assert torch.equal(got, ref)
    want = jpar.sharded_elite_selection(jpar.make_mesh(), jnp.asarray(us),
                                        jnp.asarray(costs), ne)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _fleet_case():
    prob = lqr_problem(N=6, noise=1e-3, device="cpu")
    args = (make_ileqg_plan(prob, ILEQGConfig(iter_max=15), 0.0),
            make_gaussian_simulator(prob), 4, prob.c)
    return prob, args


def test_sharded_fleet_matches_unsharded(mesh):
    """Seed-sharded fleet ≡ the unsharded fleet bit for bit, with the same
    generators."""
    prob, args = _fleet_case()
    x0 = torch.tensor([1.0, -1.0], dtype=F64)
    u0 = torch.zeros((6, 2), dtype=F64)

    def gens():
        return [torch.Generator().manual_seed(9 + s) for s in range(8)]

    got = make_sharded_fleet_runner(mesh, *args)(x0, u0, gens(), ())
    ref = make_fleet_runner(*args)(x0, u0, gens(), ())
    for name in ("xs", "us", "values", "fallbacks", "total_cost"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    assert got.xs.shape == (8, 5, 2)


def test_sharded_fleet_matches_jax_noise_table(mesh):
    """The sharded fleet against JAX's on 8 devices, both in one world
    with an injected noise table ``x⁺ = f(x, u) + w[k]`` (rtol 1e-12)."""
    steps = 4
    w = 0.05 * np.random.default_rng(0).normal(size=(steps, 2))
    prob = lqr_problem(N=6, noise=1e-3, device="cpu")
    fb, table = torch.func.vmap(prob.f), torch.tensor(w)
    got = make_sharded_fleet_runner(
        mesh, make_ileqg_plan(prob, ILEQGConfig(iter_max=15), 0.0),
        lambda k, x, u, generators: fb(x, u) + table[k], steps, prob.c)(
        torch.tensor([1.0, -1.0], dtype=F64), torch.zeros((6, 2), dtype=F64),
        [torch.Generator().manual_seed(s) for s in range(8)])
    jprob = jlqr(N=6, noise=1e-3)
    jtable = jnp.asarray(w)
    want = jpar.make_sharded_fleet_runner(
        jpar.make_mesh(), jme.make_ileqg_plan(jprob, JIL(iter_max=15), 0.0),
        lambda k, x, u, key: jprob.f(x, u) + jtable[k], steps, jprob.c)(
        jnp.array([1.0, -1.0]), jnp.zeros((6, 2)),
        jax.random.split(jax.random.key(9), 8), ())
    for name in ("xs", "us", "values", "total_cost"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-12, atol=1e-14, err_msg=name)


def test_sharded_fleet_rejects_indivisible_generators():
    prob, args = _fleet_case()
    fleet = make_sharded_fleet_runner(EightRanks(), *args)
    with pytest.raises(ValueError, match="divide evenly"):
        fleet(torch.zeros(2, dtype=F64), torch.zeros((6, 2), dtype=F64),
              [torch.Generator().manual_seed(s) for s in range(6)], ())
