"""Adaptive rank selection (Algorithm 2 of Adapprox, "AS-RSI").

S-RSI runs once at the full stored width and ``xi(k)`` for every ``k``
comes from the projection identity over the cumulative captured energy
(``srsi.py``), so the paper's repeat-loop is a loop over a precomputed
vector.  Functions take batched ``cum_energy`` (*batch, r) and
``frob_sq`` / ``k`` (*batch,).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class RankConfig:
    k_init: int = 1
    k_max: int = 128          # resolved per-matrix: min(k_max, 0.25*min(m,n))
    xi_thresh: float = 0.01
    delta_s: int = 10         # re-selection interval (steps)
    # f(xi) = | eta / (exp(omega*xi + phi) + tau) |   (Eq. 14)
    eta: float = 200.0
    omega: float = -10.0
    phi: float = -2.5
    tau: float = -9.0
    mode: str = "paper"       # "paper" | "exact" | "static"


def f_increment(xi: torch.Tensor, cfg: RankConfig) -> torch.Tensor:
    """Eq. (14): ~22 for all xi in (0, 1] with the paper's constants."""
    return torch.abs(cfg.eta / (torch.exp(cfg.omega * xi + cfg.phi)
                                + cfg.tau))


def xi_of_k(cum_energy: torch.Tensor, frob_sq: torch.Tensor,
            k: torch.Tensor) -> torch.Tensor:
    r = cum_energy.shape[-1]
    idx = torch.clamp(k.long() - 1, 0, r - 1)
    got = torch.gather(cum_energy, -1, idx.unsqueeze(-1)).squeeze(-1)
    captured = torch.where(k > 0, got, torch.zeros_like(got))
    resid = torch.clamp_min(frob_sq - captured, 0.0)
    return torch.sqrt(resid / (frob_sq + 1e-30))


def select_rank_paper_iteration(cum_energy: torch.Tensor,
                                frob_sq: torch.Tensor, cfg: RankConfig,
                                k_max: int) -> torch.Tensor:
    """Algorithm 2's repeat-loop:  k <- k_init;
    while xi(k) > thresh and k < k_max:  k <- min(k + f(xi), k_max).
    Batched like a vmapped while-loop: it runs until every matrix is done,
    and finished matrices keep their k."""
    k = torch.full(frob_sq.shape, min(cfg.k_init, k_max), dtype=torch.int32,
                   device=frob_sq.device)
    xi = xi_of_k(cum_energy, frob_sq, k)
    while True:
        live = (xi > cfg.xi_thresh) & (k < k_max)
        if not bool(live.any()):
            return k
        inc = torch.clamp_min(torch.round(f_increment(xi, cfg)).to(
            torch.int32), 1)
        k_next = torch.clamp_max(k + inc, k_max)
        xi_next = xi_of_k(cum_energy, frob_sq, k_next)
        k = torch.where(live, k_next, k)
        xi = torch.where(live, xi_next, xi)


def select_rank_exact(cum_energy: torch.Tensor, frob_sq: torch.Tensor,
                      cfg: RankConfig, k_max: int) -> torch.Tensor:
    """Minimal k with xi(k) <= thresh:
    xi(k) <= t  <=>  cum_energy[k-1] >= ||A||^2 (1 - t^2)."""
    target = frob_sq * (1.0 - cfg.xi_thresh ** 2)
    k = torch.searchsorted(cum_energy.contiguous(),
                           target.unsqueeze(-1).contiguous(),
                           side="left").squeeze(-1) + 1
    return torch.clamp(k.to(torch.int32), min(cfg.k_init, k_max), k_max)


def select_rank(cum_energy: torch.Tensor, frob_sq: torch.Tensor,
                cfg: RankConfig, k_max: int, step: int,
                k_prev: torch.Tensor, refresh_every: int = 1) -> torch.Tensor:
    """Dispatch on mode; re-selects only when ``step % delta_s == 1`` (the
    paper's "if (t mod Delta_s) = 1"), else keeps ``k_prev``.  With an
    amortized refresh (``refresh_every = T > 1``) this runs on refresh
    steps only, so the cadence is counted in refresh indices: re-select
    every ceil(delta_s / T)-th refresh."""
    if cfg.mode == "static":
        return k_prev
    if refresh_every <= 1:
        refresh = (step % cfg.delta_s) == (1 % cfg.delta_s)
    else:
        period = max(1, -(-cfg.delta_s // refresh_every))
        refresh = ((step - 1) // refresh_every) % period == 0
    if not refresh:
        return k_prev
    if cfg.mode == "exact":
        return select_rank_exact(cum_energy, frob_sq, cfg, k_max)
    return select_rank_paper_iteration(cum_energy, frob_sq, cfg, k_max)


def resolve_k_max(shape: tuple[int, ...], cfg: RankConfig,
                  frac: float = 0.25) -> int:
    """Paper: k_max = 0.25 * min(m, n), capped by the configured width."""
    m, n = shape[-2], shape[-1]
    return max(1, min(cfg.k_max, int(frac * min(m, n))))
