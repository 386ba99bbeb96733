"""RAT iLQR++ with the single-call schedule of :mod:`ratilqr_tpu.solvers.
nelder_mead_jit` (``nelder_mead_bilevel_optimization.jl:276-352``).

The host path (:mod:`ratilqr_tpu_torch.solvers.nelder_mead`) evaluates one
vertex per bank, 10-40 sequential one-lane solves a search.  This module
keeps the JAX module's decisions **and its bank schedule** — speculative
batched evaluation — with the decision replay on the host:

  - the feasibility bootstrap (halve θ until the objective is finite, ref
    :283-304) evaluates both vertices' whole 60-rung λ-ladders as ONE
    120-lane bank and takes each ladder's first finite rung;
  - one NM iteration (``step!``, ref :174-252) can only ever query 6 θs
    computable up front from the sorted simplex (reflect; expand; contract
    and shrink, each under both θ_high hypotheses), and chaining them over
    the 6 possible new vertices × 2 sort orders gives 6 / 78 / 942 lanes
    for ``speculation_depth`` 1 / 2 / 3 consecutive iterations: each round
    is ONE bank (``build_tree``), and ``replay`` then walks the realized
    subtree by group index.  On the card a 942-lane bank of a small model
    is one partly filled launch per kernel, so depth 3 costs about one
    third of the sequential rounds;
  - with ``refresh_carried_costs`` one merged bank ``[ladder_hi (60) |
    ladder_lo (60) | tree_a | tree_b]`` holds the refreshed vertices, both
    bootstrap ladders and the first speculation tree of both sort orders;
  - carried costs (``concrete``) skip the bootstrap, unless they are the
    NaN "missing" encoding a ``kl_bound == 0`` solve on a fresh state
    leaves: then the bootstrap runs, as the host path's ``_missing_c``;
  - speculative final solve: θ_opt = θ_low is a θ some bank already
    solved, so each simplex vertex's lane ``(x, l, L, value)`` is carried
    and the reference's final re-solve (ref :334-346) reuses θ_low's lane.
    A fresh one-lane solve runs only where no lane exists: the stale-c
    warm path whose θ_low was never displaced, and ``kl_bound == 0``.
    This is exact only if a lane's result does not depend on the bank
    around it.

The θ candidates, the costs and the replay's arithmetic are in the working
dtype, as in the JAX module; each bank's costs come to the host once.
The JAX module's fourth mode, carried state under tracing (``traced``, for
vmapped episode fleets), has no counterpart until ``mpc_episode`` is
ported.  Returns the host path's :class:`NMResult`; each path accepts the
other's :class:`NMState`.
"""
from __future__ import annotations

import math

import torch

from ratilqr_tpu_torch.config import NelderMeadConfig
from ratilqr_tpu_torch.problems import RiskSensitiveProblem
from ratilqr_tpu_torch.solvers.nelder_mead import (NMResult, NMState,
                                                   _MAX_BOOTSTRAP, _inputs,
                                                   host_state, init_state,
                                                   vertex_bank)
from ratilqr_tpu_torch.solvers.ratilqr import solve_one

TREE = {1: 6, 2: 78, 3: 942}   # lanes of one speculation bank, by depth
_OFFS = (0, 6, 78)             # lane offset of each depth's level


def cands(config: NelderMeadConfig, lo, hi, lo_init):
    """The 6 θs one ``step!`` can query from a sorted simplex,
    elementwise over any batch of (lo, hi) pairs: [reflect, expand,
    contract(¬keep_r), contract(keep_r), shrink(¬keep_r), shrink(keep_r)]
    (ref :195-243; shrink is unclamped there)."""
    def clamp(th):
        return torch.maximum(lo_init, th)
    th_r = clamp(lo + config.alpha * (lo - hi))
    th_e = clamp(lo + config.beta * (th_r - lo))
    th_c0 = clamp(lo + config.gamma * (hi - lo))
    th_c1 = clamp(lo + config.gamma * (th_r - lo))
    th_s0 = (hi + lo) / 2.0
    th_s1 = (th_r + lo) / 2.0
    return torch.stack([th_r, th_e, th_c0, th_c1, th_s0, th_s1], -1)


def build_tree(config: NelderMeadConfig, lo0, hi0, lo_init):
    """Candidate tree of up to ``speculation_depth`` consecutive
    ``step!``s from the sorted simplex (lo0, hi0): ``TREE[depth]`` θs, the
    level of depth s at lane ``_OFFS[s]``, hypothesis group g of a level at
    ``6 g`` within it."""
    S = config.speculation_depth
    obit = torch.tensor([False, True])
    levels = [cands(config, lo0, hi0, lo_init)]                  # (6,)
    if S >= 2:
        # hypothesis (j, o): new high = level-1 candidate j; o = the next
        # sort swapped it into the low slot.
        lo1 = torch.where(obit[None, :], levels[0][:, None], lo0)
        hi1 = torch.where(obit[None, :], lo0, levels[0][:, None])
        t2 = cands(config, lo1, hi1, lo_init)                    # (6,2,6)
        levels.append(t2.reshape(-1))
    if S >= 3:
        ob = obit.reshape(1, 1, 1, 2)
        cand2 = t2[..., None]                                    # (6,2,6,1)
        lo1e = lo1[:, :, None, None]                             # (6,2,1,1)
        lo2 = torch.where(ob, cand2, lo1e)                       # (6,2,6,2)
        hi2 = torch.where(ob, lo1e, cand2)
        levels.append(cands(config, lo2, hi2, lo_init).reshape(-1))
    return torch.cat(levels)


def solve(problem: RiskSensitiveProblem, config: NelderMeadConfig,
          state: NMState, x0, u_init, *, kl_bound) -> NMResult:
    """RAT iLQR++ ``solve!`` (ref :276-352) on the speculative schedule.

    ``state.c_high``/``c_low`` may be ``None`` (fresh state: the bootstrap
    bank runs), NaN (the missing encoding: the same) or carried costs
    (bootstrap skipped, the reference's cross-solve quirk, unless
    ``refresh_carried_costs``).  ``kl_bound == 0`` is pure iLQG and leaves
    missing costs NaN, so a later ``kl_bound > 0`` solve still bootstraps.
    """
    kl_bound = float(kl_bound)
    if kl_bound < 0:
        raise ValueError("KL divergence bound must be non-negative")
    x0, u_init = _inputs(problem, x0, u_init)
    dtype, dev = x0.dtype, x0.device
    bank = vertex_bank(problem, config.ileqg)
    st = host_state(state)
    have_c = st.c_high is not None and st.c_low is not None

    def scalar(v):
        return torch.tensor(v, dtype=dtype)

    th_hi_init0, th_lo_init0 = scalar(st.theta_high_init), scalar(
        st.theta_low_init)
    c_hi_in = scalar(st.c_high if have_c else math.nan)
    c_lo_in = scalar(st.c_low if have_c else math.nan)
    lam = scalar(config.lam)
    S = config.speculation_depth
    tree_n = TREE[S]

    def bank_eval(thetas):
        """Outer objective ``value + kl_bound/θ`` over a θ-bank, NaN → Inf
        (``compute_cost_worker``, ref :134-158), brought to the host once;
        with the bank's result, whose lanes the carry points into."""
        th = thetas.to(dev)
        res = bank(x0, u_init, th)
        cost = res.value + kl_bound / th
        cost = torch.where(torch.isnan(cost), torch.full_like(cost, math.inf),
                           cost)
        return cost.cpu(), res

    def ladders():
        ks = lam ** torch.arange(_MAX_BOOTSTRAP, dtype=dtype)
        return th_hi_init0 * ks, th_lo_init0 * ks

    def bootstrap_from(costs, res):
        """Both vertices' first finite ladder rung, or the last rung with
        the inits halved ``_MAX_BOOTSTRAP - 1`` times on a problem
        infeasible at every θ (the host loop's exhaustion)."""
        ladder_hi, ladder_lo = ladders()

        def first_finite(ladder, cs, init0, lane0):
            ok = torch.isfinite(cs)
            k = (int(ok.to(torch.int8).argmax()) if bool(ok.any())
                 else _MAX_BOOTSTRAP - 1)
            return ladder[k], cs[k], init0 * lam ** k, (res, lane0 + k)

        th_hi, c_hi, hi_init, sol_hi = first_finite(
            ladder_hi, costs[:_MAX_BOOTSTRAP], th_hi_init0, 0)
        th_lo, c_lo, lo_init, sol_lo = first_finite(
            ladder_lo, costs[_MAX_BOOTSTRAP:2 * _MAX_BOOTSTRAP],
            th_lo_init0, _MAX_BOOTSTRAP)
        return dict(th_hi=th_hi, th_lo=th_lo, c_hi=c_hi, c_lo=c_lo,
                    hi_init=hi_init, lo_init=lo_init, sol_hi=sol_hi,
                    sol_lo=sol_lo, it=0, done=False)

    def bootstrap():
        costs, res = bank_eval(torch.cat(ladders()))
        return bootstrap_from(costs, res)

    def replay(tree_thetas, tree_costs, res, base, c):
        """Walk the reference's decisions (ref :195-244) over an evaluated
        candidate tree from lane offset ``base``; the group index ``g``
        tracks the realized subtree.  Convergence inside a group ends
        it."""
        g = 0
        for s in range(S):
            if c["done"]:
                break
            swp = bool(c["c_hi"] < c["c_lo"])
            s_lo, s_cl = ((c["th_hi"], c["c_hi"]) if swp
                          else (c["th_lo"], c["c_lo"]))
            s_ch = c["c_lo"] if swp else c["c_hi"]
            s_sol_lo = c["sol_hi"] if swp else c["sol_lo"]
            at = base + _OFFS[s] + g * 6
            ths, cs = tree_thetas[at:at + 6], tree_costs[at:at + 6]
            c_r, c_e = cs[0], cs[1]
            expand = bool(c_r < s_cl)
            keep_r = not expand and bool(c_r < s_ch)
            # The transient θ_high = θ_r (ref :228) is always overwritten
            # by the contraction; only its cost feeds the shrink test.
            c_hi2 = c_r if keep_r else s_ch
            shrink = bool((cs[3] if keep_r else cs[2]) > c_hi2)
            if expand:
                j = 1 if bool(c_e < c_r) else 0
            else:
                j = (5 if shrink else 3) if keep_r else (4 if shrink else 2)
            new_hi, new_ch = ths[j], cs[j]
            it = c["it"] + 1
            c_mean = (s_cl + new_ch) / 2.0
            stdev = torch.sqrt(0.5 * ((new_ch - c_mean) ** 2
                                      + (s_cl - c_mean) ** 2))
            if config.verbose:
                print(f"**NM iter {it}: reflect (θ_r, c_r)=("
                      f"{float(ths[0]):.4g}, {float(c_r):.4g}) "
                      f"expand={expand} keep_r={keep_r} "
                      f"shrink={not expand and shrink} -> simplex (θ_lo, "
                      f"c_lo)=({float(s_lo):.4g}, {float(s_cl):.4g}) (θ_hi, "
                      f"c_hi)=({float(new_hi):.4g}, {float(new_ch):.4g}) "
                      f"stdev={float(stdev):.4g}")
            c.update(th_hi=new_hi, th_lo=s_lo, c_hi=new_ch, c_lo=s_cl,
                     sol_hi=(res, at + j), sol_lo=s_sol_lo, it=it,
                     done=bool(stdev < config.eps) or it >= config.iter_max)
            # Descend into the realized subtree: o = next round's sort bit.
            g = (g * 6 + j) * 2 + int(bool(new_ch < s_cl))
        return c

    def nm_step(c):
        """Up to ``speculation_depth`` consecutive ``step!``s as ONE
        speculative bank: build the tree from the sorted simplex, evaluate
        every lane at once, replay."""
        swap0 = bool(c["c_hi"] < c["c_lo"])
        lo0, hi0 = ((c["th_hi"], c["th_lo"]) if swap0
                    else (c["th_lo"], c["th_hi"]))
        tree = build_tree(config, lo0, hi0, c["lo_init"])
        costs, res = bank_eval(tree)
        return replay(tree, costs, res, 0, c)

    missing = (not have_c or math.isnan(st.c_high)
               or math.isnan(st.c_low))
    if kl_bound > 0:
        # initialize! (ref :164-168): θ reset from the carried inits.
        if have_c and config.refresh_carried_costs:
            # One bank covers every outcome: both refreshed vertices'
            # bootstrap ladders (whose first rungs are the vertices) and
            # the first speculation tree of both sort orders.  Both
            # vertices feasible: replay the matching tree; else decode the
            # ladders as the bootstrap.
            tree_a = build_tree(config, th_lo_init0, th_hi_init0,
                                th_lo_init0)
            tree_b = build_tree(config, th_hi_init0, th_lo_init0,
                                th_lo_init0)
            merged = torch.cat([*ladders(), tree_a, tree_b])
            cs, res = bank_eval(merged)
            c_hi0, c_lo0 = cs[0], cs[_MAX_BOOTSTRAP]
            if bool(torch.isfinite(c_hi0)) and bool(torch.isfinite(c_lo0)):
                carry = dict(th_hi=th_hi_init0, th_lo=th_lo_init0,
                             c_hi=c_hi0, c_lo=c_lo0, hi_init=th_hi_init0,
                             lo_init=th_lo_init0, sol_hi=(res, 0),
                             sol_lo=(res, _MAX_BOOTSTRAP), it=0, done=False)
                # tree_a was built for the unswapped order, tree_b for the
                # swapped one; replay's first sort recomputes the same bit.
                base = 2 * _MAX_BOOTSTRAP + (tree_n if bool(c_hi0 < c_lo0)
                                             else 0)
                carry = replay(merged, cs, res, base, carry)
            else:
                carry = bootstrap_from(cs, res)
        elif missing:
            carry = bootstrap()
        else:
            # Carried costs, the reference's quirk: no vertex lane exists.
            carry = dict(th_hi=th_hi_init0, th_lo=th_lo_init0, c_hi=c_hi_in,
                         c_lo=c_lo_in, hi_init=th_hi_init0,
                         lo_init=th_lo_init0, sol_hi=None, sol_lo=None,
                         it=0, done=False)
        while not carry["done"]:
            carry = nm_step(carry)
        theta_opt = carry["th_lo"]
    else:
        # Pure iLQG; the state is untouched beyond the reset, and missing
        # costs stay missing (NaN).
        theta_opt = scalar(0.0)
        carry = dict(th_hi=th_hi_init0, th_lo=th_lo_init0, c_hi=c_hi_in,
                     c_lo=c_lo_in, hi_init=th_hi_init0, lo_init=th_lo_init0,
                     sol_lo=None, it=0)

    # Final re-solve at θ_opt, no retry loop (ref :334-346): θ_low's
    # carried lane where it exists, else one fresh lane.
    if kl_bound > 0 and carry["sol_lo"] is not None:
        res, k = carry["sol_lo"]
        x, l, L, raw = res.x[k], res.l[k], res.L[k], res.value[k]
    else:
        r = solve_one(bank, x0, u_init, float(theta_opt))
        x, l, L, raw = r.x, r.l, r.L, r.value
    value = (raw + float(scalar(kl_bound) / theta_opt) if kl_bound > 0
             else raw)
    new_state = NMState(
        theta_high_init=float(carry["hi_init"]),
        theta_low_init=float(carry["lo_init"]),
        theta_high=float(carry["th_hi"]), theta_low=float(carry["th_lo"]),
        c_high=float(carry["c_hi"]), c_low=float(carry["c_lo"]),
        iter_current=carry["it"])
    return NMResult(theta_opt=theta_opt, x=x, l=l, L=L, value=value,
                    state=new_state)


def bootstrap_state(problem: RiskSensitiveProblem, config: NelderMeadConfig,
                    x0, u_init, *, kl_bound) -> NMState:
    """The warm-start :class:`NMState` of one full solve from the fresh
    state: the feasibility bootstrap runs, and its ``c_high``/``c_low``
    become real carried costs.  ``kl_bound`` must be positive: a
    ``kl_bound == 0`` solve skips the bootstrap and leaves the costs
    missing (NaN)."""
    if float(kl_bound) <= 0:
        raise ValueError(
            "bootstrap_state requires kl_bound > 0: the kl_bound == 0 "
            "path skips the feasibility bootstrap, so c_high/c_low stay "
            "missing")
    return solve(problem, config, init_state(config), x0, u_init,
                 kl_bound=kl_bound).state
