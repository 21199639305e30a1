"""On-device statistics: Spearman rank correlation and the Shapiro–Wilk W
(counterpart of ``rankaae_tpu/ops/stats.py:26-86``).

The reference computes these on the host with scipy every epoch
(``sc/clustering/trainer.py:286-295``); computing them on the device keeps
the epoch free of host syncs.

* :func:`spearman_rho` — ranks via double (stable) argsort + Pearson.  The
  latent styles are continuous floats, so tie handling is a measure-zero
  difference from scipy.
* :func:`shapiro_w` — Royston's AS R94 approximation (what
  scipy.stats.shapiro implements) for n > 5.
"""
from __future__ import annotations

import torch


def _ranks(x, dim=0):
    return torch.argsort(torch.argsort(x, dim=dim, stable=True), dim=dim, stable=True).float()


def spearman_rho(x, y):
    """Spearman rank correlation of two 1-D tensors."""
    rx = _ranks(x)
    ry = _ranks(y)
    rx = rx - rx.mean()
    ry = ry - ry.mean()
    denom = torch.sqrt(torch.sum(rx * rx) * torch.sum(ry * ry))
    return torch.sum(rx * ry) / torch.clamp(denom, min=1e-12)


def max_interstyle_spearman(styles):
    """max |spearman(style_i, style_j)| over all style pairs
    (reference ``trainer.py:288-293``), per trial.  styles: (T, N, nstyle)
    -> (T,)."""
    styles = styles.float()
    nstyle = styles.shape[-1]
    ranks = _ranks(styles, dim=1)
    ranks = ranks - ranks.mean(dim=1, keepdim=True)
    cov = ranks.transpose(1, 2) @ ranks
    d = torch.sqrt(torch.diagonal(cov, dim1=1, dim2=2))
    corr = cov / torch.clamp(d[:, :, None] * d[:, None, :], min=1e-12)
    mask = torch.triu(torch.ones((nstyle, nstyle), dtype=torch.bool, device=styles.device),
                      diagonal=1)
    return torch.amax(torch.where(mask, corr.abs(), torch.zeros_like(corr)), dim=(1, 2))


_P1 = (-2.706056, 4.434685, -2.071190, -0.147981, 0.221157)
_P2 = (-3.582633, 5.682633, -1.752461, -0.293762, 0.042981)


def _shapiro_w_columns(x):
    """Shapiro–Wilk W of each column of x (n, m) -> (m,)."""
    x = x.float()
    n = x.shape[0]
    dev = x.device
    xs = torch.sort(x, dim=0).values
    i = torch.arange(1, n + 1, dtype=torch.float32, device=dev)
    m = torch.special.ndtri((i - 0.375) / (n + 0.25))
    m_sq = torch.sum(m * m)
    c = m / torch.sqrt(m_sq)

    u = 1.0 / torch.sqrt(torch.tensor(float(n), dtype=torch.float32, device=dev))
    # Royston's polynomial corrections for the two extreme weights.
    upow = torch.stack([u**5, u**4, u**3, u**2, u])
    a_n = c[-1] + torch.sum(torch.tensor(_P1, dtype=torch.float32, device=dev) * upow)
    a_n1 = c[-2] + torch.sum(torch.tensor(_P2, dtype=torch.float32, device=dev) * upow)

    phi = (m_sq - 2.0 * m[-1] ** 2 - 2.0 * m[-2] ** 2) / (
        1.0 - 2.0 * a_n**2 - 2.0 * a_n1**2)
    a = m / torch.sqrt(phi)
    a = torch.cat([torch.stack([-a_n, -a_n1]), a[2:-2], torch.stack([a_n1, a_n])])

    num = torch.square(torch.sum(a[:, None] * xs, dim=0))
    den = torch.sum(torch.square(x - x.mean(dim=0, keepdim=True)), dim=0)
    return num / torch.clamp(den, min=1e-30)


def shapiro_w(x):
    """Shapiro–Wilk W statistic of a 1-D sample (Royston 1995, AS R94)."""
    return _shapiro_w_columns(x[:, None])[0]


def min_style_shapiro(styles):
    """min over style dims of Shapiro–Wilk W (reference ``trainer.py:287,294``),
    per trial.  styles: (T, N, nstyle) -> (T,)."""
    t, n, nstyle = styles.shape
    w = _shapiro_w_columns(styles.transpose(0, 1).reshape(n, t * nstyle))
    return torch.amin(w.view(t, nstyle), dim=1)
