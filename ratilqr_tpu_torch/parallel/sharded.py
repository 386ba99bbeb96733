"""Sample-axis sharding of the θ-bank, PETS and MPC fleets over the ranks
of a mesh, counterpart of :mod:`ratilqr_tpu.parallel.sharded`.

JAX annotates the sample axis inside ``jit`` and lets GSPMD partition the
work, or maps a function over the shards with ``shard_map``.  Here every
rank runs the same program on its contiguous block of the sample axis (rank
r holds samples ``r·b … r·b + b − 1``), and the results come back to every
rank by ``all_gather`` over the mesh's process group, in sample order, on
the device they were computed on.  Sharding changes placement, not the
result: a lane of the port's bank depends on no other lane, so each
function returns what its unsharded twin returns on the whole sample axis.

Where JAX pads a sample axis that does not divide over the mesh (GSPMD's
θ-bank and PETS), the last blocks are padded here with copies of the last
sample and the padding is trimmed; where JAX requires division
(``shard_map``, the fleet), so does the port.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ratilqr_tpu_torch.config import CrossEntropyConfig, PETSConfig
from ratilqr_tpu_torch.mpc_episode import EpisodeResult, make_fleet_runner
from ratilqr_tpu_torch.parallel.mesh import SAMPLE_AXIS
from ratilqr_tpu_torch.problems import (GenerativeProblem,
                                        RiskSensitiveProblem, problem_device)
from ratilqr_tpu_torch.solvers import pets as pets_mod
from ratilqr_tpu_torch.solvers import ratilqr
from ratilqr_tpu_torch.utils.tree import tree_map

Tensor = torch.Tensor

# Golden-ratio increment of splitmix64: spreads the ranks' seeds apart.
_SEED_STRIDE = 0x9E3779B97F4A7C15


def _all_gather(x: Tensor, mesh: DeviceMesh) -> Tensor:
    """Every rank's ``x`` (equal shapes), concatenated in rank order on
    the leading axis, on ``x``'s device."""
    parts = [torch.empty_like(x) for _ in range(mesh.size())]
    dist.all_gather(parts, x.contiguous(), group=mesh.get_group())
    return torch.cat(parts)


def _padded_block(num: int, mesh: DeviceMesh, device) -> Tensor:
    """The indices of this rank's block of ``num`` samples, ``ceil(num /
    size)`` of them, a block past the end padded with the last sample."""
    b = -(-num // mesh.size())
    start = mesh.get_local_rank() * b
    return torch.arange(start, start + b, device=device).clamp(max=num - 1)


def _even_block(num: int, mesh: DeviceMesh, what: str) -> slice:
    """This rank's block of ``num`` samples, which must divide evenly."""
    size = mesh.size()
    if num % size:
        raise ValueError(f"{what} ({num}) must divide evenly over the "
                         f"{size}-rank '{SAMPLE_AXIS}' mesh axis")
    b = num // size
    return slice(mesh.get_local_rank() * b, (mesh.get_local_rank() + 1) * b)


def make_sharded_theta_cost_fn(problem: RiskSensitiveProblem,
                               config: CrossEntropyConfig, mesh: DeviceMesh):
    """CE outer objective with the θ axis sharded over the mesh: a drop-in
    for :func:`ratilqr_tpu_torch.solvers.ratilqr.make_cost_fn`,
    ``cost_fn(x0, u_init, thetas, kl_bound) -> (K,)`` on every rank.

    Replaces the reference's per-θ ``remotecall_fetch`` fan-out
    (``cross_entropy_bilevel_optimization.jl:180-192``): each rank solves
    its block of θ through the port's bank on the problem's device (the
    kernels of the configuration's path), with ``make_cost_fn``'s NaN →
    +Inf rule, and the costs are gathered in θ order.  Any K: a short last
    block is padded with the last θ and trimmed.  ``cost_fn.bank`` is the
    rank's bank.
    """
    local = ratilqr.make_cost_fn(problem, config)
    dev = problem_device(problem)

    def cost_fn(x0, u_init, thetas, kl_bound) -> Tensor:
        x0 = torch.as_tensor(x0, device=dev)
        thetas = torch.as_tensor(thetas, dtype=x0.dtype, device=dev)
        K = thetas.shape[0]
        block = thetas[_padded_block(K, mesh, dev)]
        return _all_gather(local(x0, u_init, block, kl_bound), mesh)[:K]

    cost_fn.bank = local.bank
    return cost_fn


def _rank_generator(generator: torch.Generator, rank: int
                    ) -> torch.Generator:
    """A generator for this rank's draws, on ``generator``'s device,
    seeded from one draw of ``generator`` (the same on every rank, whose
    generators are replicated) mixed with the rank: the twin of JAX's
    ``fold_in(key, axis_index)``."""
    seed = int(torch.randint(0, 2 ** 62, (), generator=generator,
                             device=generator.device))
    out = torch.Generator(device=generator.device)
    out.manual_seed((seed ^ (_SEED_STRIDE * (rank + 1))) % 2 ** 63)
    return out


def compute_cost_shard_map(problem: GenerativeProblem, config: PETSConfig,
                           mesh: DeviceMesh, x0: Tensor,
                           control_sequences: Tensor,
                           generator: Optional[torch.Generator] = None,
                           use_true_model: bool = False,
                           noise: Optional[Sequence] = None) -> Tensor:
    """PETS Monte-Carlo cost of the K control sequences, each rank
    evaluating its block (the reference's per-worker
    ``compute_cost_worker``, ``pets.jl:76-98``) through
    :func:`pets.compute_cost <ratilqr_tpu_torch.solvers.pets.
    compute_cost>`; returns the ``(K,)`` costs on every rank.

    Each rank draws from its own stream, derived from ``generator`` and
    the rank (one draw of ``generator``, which every rank advances alike),
    so the result is deterministic for a given generator state and world
    size.  ``noise`` instead supplies the whole bank's per-step draws (as
    :func:`pets.compute_cost` takes them, ``K·M`` lanes); each rank reads
    its lanes.  K must divide evenly over the ranks.
    """
    own = _even_block(control_sequences.shape[0], mesh,
                      "num_control_samples")
    if noise is None:
        generator = _rank_generator(generator, mesh.get_local_rank())
    else:
        M = config.num_trajectory_samples
        lanes = slice(own.start * M, own.stop * M)
        noise = [tree_map(lambda w: w[lanes], w_t) for w_t in noise]
    costs = pets_mod.compute_cost(problem, config, x0,
                                  control_sequences[own], generator,
                                  use_true_model, noise)
    return _all_gather(costs, mesh)


def sharded_elite_selection(mesh: DeviceMesh, us: Tensor, costs: Tensor,
                            num_elite: int) -> Tensor:
    """Communication-optimal elite selection: each rank's top
    ``num_elite`` of its block by a stable sort, the candidates gathered
    in rank order, then the merged top ``num_elite``.

    ``us (b, N, m)`` and ``costs (b,)`` are this rank's block, the blocks
    contiguous in rank order and of one size.  The global top-k is always
    a subset of the union of the blocks' top-ks, so gathering only those
    (size·num_elite sequences, not all K) is exact: the result, the same
    on every rank, equals :func:`pets.get_elite_samples
    <ratilqr_tpu_torch.solvers.pets.get_elite_samples>` on the whole bank,
    ties to the lower global index.
    """
    idx = torch.sort(costs, stable=True).indices[:num_elite]
    all_us = _all_gather(us[idx], mesh)
    all_c = _all_gather(costs[idx], mesh)
    return all_us[torch.sort(all_c, stable=True).indices[:num_elite]]


def make_sharded_pets_solve(problem: GenerativeProblem, config: PETSConfig,
                            mesh: DeviceMesh, use_true_model: bool = False,
                            shard_elites: bool = False):
    """PETS ``solve`` with the control-sample axis sharded:
    ``solve(x0, state, generator) -> PETSState``, equal to
    :func:`pets.solve <ratilqr_tpu_torch.solvers.pets.solve>` with the
    same (replicated) generator.

    Each generation samples the whole control bank on every rank, then
    draws the whole bank's rollout noise, step by step as
    :func:`~ratilqr_tpu_torch.ops.rollout.rollout_generative` draws it
    (``draw_noise`` reads only the bank's shape, dtype and device), so the
    generator's stream is the unsharded solve's; each rank evaluates its
    block of sequences.  The elites come from the gathered costs, or with
    ``shard_elites`` from :func:`sharded_elite_selection`.  Any K: a short
    last block is padded with the last sequence (its padded costs +Inf
    for the elite selection) and trimmed.
    """
    K, M = config.num_control_samples, config.num_trajectory_samples
    dev = problem_device(problem)
    own = _padded_block(K, mesh, dev)
    lanes = (own[:, None] * M + torch.arange(M, device=dev)).reshape(-1)
    start = mesh.get_local_rank() * own.shape[0]
    padded = torch.arange(start, start + own.shape[0], device=dev) >= K

    def sharded_solve(x0, state, generator: torch.Generator):
        state = state._replace(mu=state.mu.to(dev),
                               sigma=state.sigma.to(dev))
        x0 = torch.as_tensor(x0, dtype=state.mu.dtype, device=dev)
        bank = x0.expand(K * M, -1)
        for _ in range(config.iter_max):
            us = pets_mod.sample_control_sequences(state, generator, K)
            noise = [tree_map(lambda w: w[lanes], problem.draw_noise(
                generator, bank, use_true_model)) for _ in range(problem.N)]
            costs = pets_mod.compute_cost(problem, config, x0, us[own],
                                          use_true_model=use_true_model,
                                          noise=noise)
            if shard_elites:
                costs = torch.where(padded, torch.full_like(costs, np.inf),
                                    costs)
                elites = sharded_elite_selection(mesh, us[own], costs,
                                                 config.num_elite)
            else:
                elites, _ = pets_mod.get_elite_samples(
                    us, _all_gather(costs, mesh)[:K], config.num_elite)
            state = pets_mod.compute_new_distribution(
                state, elites, config.smoothing_factor)
            state = state._replace(iter_current=state.iter_current + 1)
        return state

    return sharded_solve


def _gather_seeds(tree: Any, mesh: DeviceMesh, b: int) -> Any:
    """A fleet block's result gathered over the ranks in seed order: a
    tensor with the seed axis (leading, of length ``b``) by
    ``all_gather``, a list of ``b`` per-seed items by
    ``all_gather_object``; anything else (0-d tensors, Python scalars,
    ``()``) is the same on every rank and kept."""
    if isinstance(tree, list) and len(tree) == b:
        parts = [None] * mesh.size()
        dist.all_gather_object(parts, tree, group=mesh.get_group())
        return [item for part in parts for item in part]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_gather_seeds(x, mesh, b) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_gather_seeds(x, mesh, b) for x in tree)
    if isinstance(tree, dict):
        return {k: _gather_seeds(v, mesh, b) for k, v in tree.items()}
    if isinstance(tree, Tensor) and tree.dim() and tree.shape[0] == b:
        return _all_gather(tree, mesh)
    return tree


def make_sharded_fleet_runner(mesh: DeviceMesh, plan_step, simulate,
                              num_steps: int, stage_cost, fallback=None):
    """Monte-Carlo episode fleet with the seed axis sharded over the mesh,
    counterpart of :func:`ratilqr_tpu_torch.mpc_episode.make_fleet_runner`
    (same arguments): ``fleet(x0, u_init, generators, plan_state=()) ->
    EpisodeResult`` on every rank.

    Each rank runs the closed-loop episodes of its block of seeds (its
    block of the per-seed generators) as one fleet; episodes never talk to
    each other, so every ``EpisodeResult`` field, the final per-seed plan
    states included, is gathered back in seed order and equals the
    unsharded fleet's.  ``x0``, ``u_init`` and ``plan_state`` are
    replicated.  The seeds must divide evenly over the ranks.
    """
    run = make_fleet_runner(plan_step, simulate, num_steps, stage_cost,
                            fallback)

    def fleet(x0: Tensor, u_init: Tensor,
              generators: Sequence[torch.Generator],
              plan_state: Any = ()) -> EpisodeResult:
        own = _even_block(len(generators), mesh,
                          "the number of episode generators")
        out = run(x0, u_init, list(generators)[own], plan_state)
        return _gather_seeds(out, mesh, own.stop - own.start)

    return fleet
