"""Structured friction-cone coupling matrix.

Counterpart of ``lcp_physics_tpu/lcp/cone.py``.  The engine's F block,
F = [[0,0,0],[0,0,-E],[-diag(mu),E^T,0]], is carried as the per-contact
friction coefficients ``mu`` and the validity mask; E is ``fd`` stacked
(masked) identities.  Row layout (m = C * (2 + fd)):
[normal (C); friction (fd*C); gamma (C)].
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class ConeF:
    """mu (..., C) masked friction coefficients; valid (..., C) float mask;
    fd tangent-direction count."""

    mu: torch.Tensor
    valid: torch.Tensor
    fd: int = 2

    @property
    def C(self):
        return self.mu.shape[-1]

    @property
    def m(self):
        return self.C * (2 + self.fd)

    @property
    def dtype(self):
        return self.mu.dtype

    @property
    def shape(self):
        """The (..., m, m) shape of the matrix it stands for."""
        return tuple(self.mu.shape[:-1]) + (self.m, self.m)

    def dense(self):
        """The (..., m, m) matrix, for the solver's generic dense paths."""
        C, fd, m = self.C, self.fd, self.m
        F = self.mu.new_zeros(self.shape)
        eye = torch.eye(C, dtype=self.mu.dtype, device=self.mu.device)
        vf = torch.cat([self.valid] * fd, dim=-1)
        Ev = (torch.cat([eye] * fd, dim=0) * vf[..., None]
              * self.valid[..., None, :])                   # (..., fd*C, C)
        F[..., C:C + fd * C, C + fd * C:m] = -Ev
        F[..., C + fd * C:, :C] = -self.mu[..., None] * eye
        F[..., C + fd * C:, C:C + fd * C] = Ev.transpose(-1, -2)
        return F

    def matvec(self, lam):
        """F @ lam for lam (..., m)."""
        C, fd = self.C, self.fd
        lam_n = lam[..., :C]
        beta = lam[..., C:C + fd * C]
        gamma = lam[..., C + fd * C:]
        fric = -torch.cat([self.valid * gamma] * fd, dim=-1)
        beta_sum = sum(beta[..., d * C:(d + 1) * C] for d in range(fd))
        g_rows = -self.mu * lam_n + self.valid * beta_sum
        return torch.cat([torch.zeros_like(lam_n), fric, g_rows], dim=-1)
