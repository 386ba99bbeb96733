"""Shared test fixtures of the port, importable from test modules."""
import pytest
import torch

from ratilqr_tpu_torch.problems import GenerativeProblem


def uniform_problem(N: int = 20, device="cuda") -> GenerativeProblem:
    """The PETS test problem (``test/pets_test.jl:12-15``): the
    additive-uniform generative integrator ``x + u + U[0, 1)^n`` with the
    state-independent cost ``Σ|u|`` and ``h = 1``, on ``device`` (the card
    unless the caller asks for ``"cpu"``)."""

    def f_stochastic(x, u, noise, use_true_model=False):
        return x + u + noise

    def draw_noise(generator, x, use_true_model=False):
        return torch.rand(x.shape, generator=generator, dtype=x.dtype,
                          device=generator.device).to(x.device)

    return GenerativeProblem(
        f_stochastic=f_stochastic, draw_noise=draw_noise,
        c=lambda k, x, u: torch.sum(torch.abs(u)),
        h=lambda x: torch.ones((), dtype=x.dtype, device=x.device),
        N=N, device=device)


@pytest.fixture
def pets_uniform_problem() -> GenerativeProblem:
    """:func:`uniform_problem` on the CPU, the fixture of
    :mod:`ratilqr_tpu.tests_support`."""
    return uniform_problem(device="cpu")
