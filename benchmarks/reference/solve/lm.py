"""Fixed-iteration Levenberg-Marquardt on SE(3) (port of
``velo_tpu/solve/lm.py``): the 6-DoF ``lm_solve`` with its deferred-reject
loops, and the 12-DoF ``lm_solve_ct`` over the pose and the sweep motion.

A dense-normal-equations LM with Jacobi scaling and an accept/reject
damping schedule, run as a fixed number of masked iterations: every
decision is a ``torch.where`` on device tensors, so a solve never waits
for the host.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from benchmarks.reference import fp
from benchmarks.reference.geom import linalg as lin3
from benchmarks.reference.geom import se3


class LMState(NamedTuple):
    T: torch.Tensor  # (4,4) current pose estimate
    lam: torch.Tensor  # damping
    cost: torch.Tensor  # cost at T
    converged: torch.Tensor  # bool: stop updating (delta below tol)
    last_delta: torch.Tensor  # |delta| of the last accepted step
    n_accept: torch.Tensor  # int32: accepted steps


def _keep_projector(H0: torch.Tensor, cfg) -> torch.Tensor | None:
    """Degeneracy-aware solution remapping: the (6, 6) projector onto the
    well-observed directions of ``H0``, or None when the remap is off.

    The translation and rotation 3x3 blocks are analyzed separately (their
    units differ), with a gate relative to each block's strongest
    eigenvalue; the weak directions are projected out of every step so the
    motion prior survives along them."""
    if cfg.degen_rel_min <= 0.0:
        return None
    B = torch.stack([H0[:3, :3], H0[3:, 3:]])
    evals, V = lin3.sym_eig3x3(0.5 * (B + B.transpose(-1, -2)))
    keep = (evals > cfg.degen_rel_min * evals[..., 2:3]).to(H0.dtype)
    P_blk = fp.einsum("bik,bk,bjk->bij", V, keep, V)
    return torch.block_diag(P_blk[0], P_blk[1])


def _jacobi_solve(H, g, damp):
    """Solve (damped H) delta = -g in units of sqrt(diag(H)) (Jacobi
    scaling): ``damp(Hs, eye)`` adds the damping to the scaled H.  Returns
    (delta, bad) with ``bad`` set where the factorization failed."""
    eye = torch.eye(H.shape[0], dtype=H.dtype, device=H.device)
    D = fp.sqrt(torch.diagonal(H) + 1e-8)
    Hs = H / (D[:, None] * D[None, :])
    gs = g / D
    # cholesky_ex reports a non-PD matrix in `info` instead of raising
    # (and without a host sync); that step is then rejected.  Solved in
    # float64 so that CPU and GPU libraries round the step alike.
    L, info = torch.linalg.cholesky_ex(damp(Hs, eye).to(fp.F64))
    delta = torch.cholesky_solve(-gs.to(fp.F64)[:, None], L)[:, 0]
    return delta.to(D.dtype) / D, info != 0


def _damped_step(H, g, lam, P_keep):
    """The LM step from one linearization: (delta (6,), bad)."""
    delta, bad = _jacobi_solve(
        H, g, lambda Hs, eye: Hs + lam * eye + 1e-7 * eye)
    if P_keep is not None:
        delta = fp.matmul(P_keep, delta[:, None])[:, 0]
    bad = bad | ~torch.all(torch.isfinite(delta))
    return torch.where(bad, 0.0, delta), bad


def _init_state(T0, cfg, cost) -> LMState:
    dev, dt = T0.device, T0.dtype
    return LMState(
        T=T0,
        lam=torch.full((), cfg.lm_lambda_init, dtype=dt, device=dev),
        cost=cost,
        converged=torch.zeros((), dtype=torch.bool, device=dev),
        last_delta=torch.full((), torch.inf, dtype=dt, device=dev),
        n_accept=torch.zeros((), dtype=torch.int32, device=dev),
    )


def _advance(st: LMState, cfg, accept, T_try, cost_try, cost, delta):
    """The state after one accept/reject decision."""
    lam_new = torch.where(accept, st.lam * cfg.lm_lambda_down,
                          st.lam * cfg.lm_lambda_up)
    lam_new = torch.clamp(lam_new, 1e-9, 1e6)
    step = fp.norm(delta)
    return LMState(
        T=torch.where(accept, T_try, st.T),
        lam=torch.where(st.converged, st.lam, lam_new),
        cost=torch.where(accept, cost_try, cost),
        converged=st.converged | (accept & (step < cfg.converge_tol)),
        last_delta=torch.where(accept, step, st.last_delta),
        n_accept=st.n_accept + accept.to(torch.int32),
    )


def lm_solve(build_system: Callable | None, T0: torch.Tensor, cfg,
             iters: int | None = None, stage: Callable | None = None,
             deferred: bool = False):
    """Run masked fixed-iteration LM from T0; returns (T_opt, final state).

    ``build_system(T) -> (H, g, cost)`` linearizes the classic system.
    ``stage(T, basis) -> (H, g, cost, trial_cost, basis)`` (the staged
    observability prior, ``prior_obs_impl="staged"``) replaces it: the
    prior's eigenbasis is re-derived for the first
    ``cfg.prior_obs_stage_iters`` iterations and then reused, and
    ``trial_cost`` scores candidate steps under the iteration's basis.

    ``deferred`` selects the deferred-reject loops: with ``build_system``
    (the full dynamic system, ``prior_obs_impl="deferred"``) each trial
    point is fully linearized and its cost decides accept/reject; with
    ``stage`` (``"deferred_tail"``) the same, except that the last
    iteration scores its trial under the carried basis.
    """
    iters = cfg.lm_iters if iters is None else iters
    if deferred:
        if stage is not None:
            return _lm_solve_deferred_tail(stage, T0, cfg, iters)
        return _lm_solve_deferred(build_system, T0, cfg, iters)
    dev, dt = T0.device, T0.dtype

    def cost_only(T):
        return build_system(T)[2]

    P_keep = None
    if cfg.degen_rel_min > 0.0:
        P_keep = _keep_projector(
            stage(T0)[0] if stage is not None else build_system(T0)[0], cfg)

    basis = None
    # The initial cost is only read when iters == 0; every iteration
    # re-linearizes at st.T.
    st = _init_state(T0, cfg, cost_only(T0) if stage is None and iters == 0
                     else torch.full((), torch.inf, dtype=dt, device=dev))
    for i in range(iters):
        if stage is not None:
            reuse = basis if i >= cfg.prior_obs_stage_iters else None
            H, g, cost, trial_cost, basis = stage(st.T, reuse)
        else:
            H, g, cost = build_system(st.T)
            trial_cost = cost_only
        delta, bad = _damped_step(H, g, st.lam, P_keep)
        T_try = se3.compose(se3.exp(delta), st.T)
        cost_try = trial_cost(T_try)
        accept = (cost_try < cost) & ~bad & ~st.converged
        st = _advance(st, cfg, accept, T_try, cost_try, cost, delta)
    return st.T, st


def _lm_solve_deferred(build_system, T0, cfg, iters: int):
    """Deferred-reject LM: the state carries the last accepted
    linearization (H, g, cost at T).  Each iteration takes the damped step
    from it and fully linearizes the trial point; the trial's cost decides
    accept/reject and, on accept, its (H, g) seed the next step: one system
    build per iteration plus the initial one, with the accept sequence of
    the classic loop on the same dynamic cost."""
    H, g, c0 = build_system(T0)
    P_keep = _keep_projector(H, cfg)
    st = _init_state(T0, cfg, c0)
    for _ in range(iters):
        delta, bad = _damped_step(H, g, st.lam, P_keep)
        T_try = se3.compose(se3.exp(delta), st.T)
        H_try, g_try, cost_try = build_system(T_try)
        # A non-finite trial linearization must not be accepted: its H/g
        # would poison every later step.
        bad_try = ~(torch.isfinite(cost_try)
                    & torch.all(torch.isfinite(g_try)))
        accept = (cost_try < st.cost) & ~bad & ~bad_try & ~st.converged
        H = torch.where(accept, H_try, H)
        g = torch.where(accept, g_try, g)
        st = _advance(st, cfg, accept, T_try, cost_try, st.cost, delta)
    return st.T, st


def _lm_solve_deferred_tail(stage, T0, cfg, iters: int):
    """Deferred-reject LM with a staged final accept.

    As :func:`_lm_solve_deferred` for the first ``iters - 1`` steps, each
    trial linearized by ``stage(T_try)`` (basis re-derived there, so the
    costs are the dynamic ones).  The last iteration's trial is scored
    under the basis carried with the current linearization, where the
    frozen cost coincides with the dynamic one; its H and g are not used.
    """
    H, g, c0, _, basis = stage(T0)
    P_keep = _keep_projector(H, cfg)
    st = _init_state(T0, cfg, c0)
    for i in range(iters):
        delta, bad = _damped_step(H, g, st.lam, P_keep)
        T_try = se3.compose(se3.exp(delta), st.T)
        if i == iters - 1:
            cost_try = stage(T_try, basis)[2]
            accept = ((cost_try < st.cost) & ~bad & torch.isfinite(cost_try)
                      & ~st.converged)
        else:
            H_t, g_t, cost_try, _, basis_t = stage(T_try)
            bad_try = ~(torch.isfinite(cost_try)
                        & torch.all(torch.isfinite(g_t)))
            accept = (cost_try < st.cost) & ~bad & ~bad_try & ~st.converged
            H = torch.where(accept, H_t, H)
            g = torch.where(accept, g_t, g)
            basis = type(basis)(*(torch.where(accept, a, b)
                                  for a, b in zip(basis_t, basis)))
        st = _advance(st, cfg, accept, T_try, cost_try, st.cost, delta)
    return st.T, st


class LMStateCT(NamedTuple):
    T: torch.Tensor  # (4,4)
    xi2: torch.Tensor  # (6,) sweep-motion estimate
    lam: torch.Tensor
    cost: torch.Tensor
    converged: torch.Tensor
    n_accept: torch.Tensor  # int32 accepted steps


def lm_solve_ct(build_system: Callable | None, T0: torch.Tensor,
                xi2_0: torch.Tensor, cfg, iters: int | None = None,
                stage: Callable | None = None):
    """12-DoF LM over (pose, sweep motion), the continuous-time solve;
    returns (T_opt, xi2_opt, LMStateCT).

    ``build_system(T, xi2) -> (H (12,12), g (12,), cost)``, or ``stage(T,
    xi2, basis)`` as in :func:`lm_solve`.  The retraction is ``T <-
    exp(delta[:6]) T`` and ``xi2 <- xi2 + delta[6:]``.  No degeneracy
    projector, as in the reference.
    """
    iters = cfg.lm_iters if iters is None else iters
    dev, dt = T0.device, T0.dtype

    def cost_only(T, xi2):
        return build_system(T, xi2)[2]

    st = LMStateCT(
        T=T0, xi2=xi2_0,
        lam=torch.full((), cfg.lm_lambda_init, dtype=dt, device=dev),
        cost=(torch.full((), torch.inf, dtype=dt, device=dev)
              if stage is not None else cost_only(T0, xi2_0)),
        converged=torch.zeros((), dtype=torch.bool, device=dev),
        n_accept=torch.zeros((), dtype=torch.int32, device=dev))
    basis = None
    for i in range(iters):
        if stage is not None:
            reuse = basis if i >= cfg.prior_obs_stage_iters else None
            H, g, cost, trial_cost, basis = stage(st.T, st.xi2, reuse)
        else:
            H, g, cost = build_system(st.T, st.xi2)
            trial_cost = cost_only
        lam = st.lam
        delta, bad = _jacobi_solve(
            H, g, lambda Hs, eye: Hs + (lam + 1e-7) * eye)
        bad = bad | ~torch.all(torch.isfinite(delta))
        delta = torch.where(bad, 0.0, delta)
        T_try = se3.compose(se3.exp(delta[:6]), st.T)
        xi2_try = st.xi2 + delta[6:]
        cost_try = trial_cost(T_try, xi2_try)
        accept = (cost_try < cost) & ~bad & ~st.converged
        lam_new = torch.where(accept, st.lam * cfg.lm_lambda_down,
                              st.lam * cfg.lm_lambda_up)
        step = fp.norm(delta)
        st = LMStateCT(
            T=torch.where(accept, T_try, st.T),
            xi2=torch.where(accept, xi2_try, st.xi2),
            lam=torch.where(st.converged, st.lam,
                            torch.clamp(lam_new, 1e-9, 1e6)),
            cost=torch.where(accept, cost_try, cost),
            converged=st.converged | (accept & (step < cfg.converge_tol)),
            n_accept=st.n_accept + accept.to(torch.int32))
    return st.T, st.xi2, st
