"""Streaming Dynamic Mode Decomposition on device.

Replaces the reference's vendored dmdtools StreamingDMD
(motion/streaming_dmd.py:13-124, Hemati, Williams & Rowley, "Dynamic mode
decomposition for large and streaming datasets", Phys. Fluids 26, 2014):
rank-limited incremental updates of paired snapshot bases with
Gram–Schmidt expansion and POD-compression, maintaining the small matrices
(Gx, Gy, A) from which DMD eigenpairs are recovered at any time.

All linear algebra is torch on the tracker's device: the per-snapshot
update is two matvec-projections + outer-product accumulations — tiny, but
the snapshot vectors themselves are full frames, so keeping them on device
avoids a host↔device copy per frame. ``compute_modes`` (pinv and the
general eig) runs on the host.

Port of the JAX package's ``motion/streaming_dmd.py``, in float32 as the
reference; ``StreamingDMD.from_arrays`` carries a tracker's state in from
numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import checked


class StreamingDMD:
    def __init__(self, max_rank=0, ngram=5, epsilon=np.finfo(np.float32).eps,
                 device="cuda"):
        self.max_rank = max_rank
        self.ngram = ngram
        self.eps = epsilon
        self.device = checked(device, "StreamingDMD")
        self.Qx = None   # (n, rx) orthonormal basis for x-snapshots
        self.Qy = None
        self.A = None    # (ry, rx)
        self.Gx = None   # (rx, rx) gram
        self.Gy = None

    @classmethod
    def from_arrays(cls, Qx, Qy, A, Gx, Gy, max_rank=0, ngram=5,
                    epsilon=np.finfo(np.float32).eps, device="cuda"):
        """A tracker whose bases and small matrices are these arrays (as
        float32 on device): the state another tracker carried."""
        self = cls(max_rank, ngram, epsilon, device)
        self.Qx, self.Qy, self.A, self.Gx, self.Gy = (
            torch.tensor(np.asarray(m, np.float32), device=self.device)
            for m in (Qx, Qy, A, Gx, Gy))
        return self

    def _vec(self, v):
        return torch.as_tensor(np.asarray(v, np.float32),
                               device=self.device).ravel()

    def update(self, x, y):
        """Process one snapshot pair y ≈ A_full x."""
        x = self._vec(x)
        y = self._vec(y)
        normx = float(torch.linalg.vector_norm(x))
        normy = float(torch.linalg.vector_norm(y))

        if self.Qx is None:
            self.Qx = (x / max(normx, 1e-30))[:, None]
            self.Qy = (y / max(normy, 1e-30))[:, None]
            self.Gx = x.new_zeros((1, 1))
            self.Gy = x.new_zeros((1, 1))
            self.A = x.new_zeros((1, 1))

        # -- Gram-Schmidt: expand bases if the residual is significant -----
        xtilde = self.Qx.T @ x
        ytilde = self.Qy.T @ y
        for _ in range(self.ngram):
            ex = x - self.Qx @ xtilde
            xtilde = xtilde + self.Qx.T @ ex
            ey = y - self.Qy @ ytilde
            ytilde = ytilde + self.Qy.T @ ey
        ex = x - self.Qx @ xtilde
        ey = y - self.Qy @ ytilde
        nex = torch.linalg.vector_norm(ex)
        if float(nex) / max(normx, 1e-30) > self.eps ** 0.5:
            self.Qx = torch.cat([self.Qx, (ex / nex)[:, None]], 1)
            self.Gx = torch.nn.functional.pad(self.Gx, (0, 1, 0, 1))
            self.A = torch.nn.functional.pad(self.A, (0, 1, 0, 0))
        ney = torch.linalg.vector_norm(ey)
        if float(ney) / max(normy, 1e-30) > self.eps ** 0.5:
            self.Qy = torch.cat([self.Qy, (ey / ney)[:, None]], 1)
            self.Gy = torch.nn.functional.pad(self.Gy, (0, 1, 0, 1))
            self.A = torch.nn.functional.pad(self.A, (0, 0, 0, 1))

        # -- POD compression when over rank budget -------------------------
        if self.max_rank:
            if self.Qx.shape[1] > self.max_rank:
                evals, evecs = torch.linalg.eigh(self.Gx)
                q = evecs[:, -self.max_rank:].flip(1)
                self.Qx = self.Qx @ q
                self.A = self.A @ q
                self.Gx = torch.diag(evals[-self.max_rank:].flip(0))
            if self.Qy.shape[1] > self.max_rank:
                evals, evecs = torch.linalg.eigh(self.Gy)
                q = evecs[:, -self.max_rank:].flip(1)
                self.Qy = self.Qy @ q
                self.A = q.T @ self.A
                self.Gy = torch.diag(evals[-self.max_rank:].flip(0))

        # -- rank-1 accumulation -------------------------------------------
        xtilde = self.Qx.T @ x
        ytilde = self.Qy.T @ y
        self.Gx = self.Gx + torch.outer(xtilde, xtilde)
        self.Gy = self.Gy + torch.outer(ytilde, ytilde)
        self.A = self.A + torch.outer(ytilde, xtilde)
        return self

    def compute_modes(self):
        """Returns (modes (n, r) complex, eigenvalues (r,) complex)."""
        import numpy.linalg as la

        Qx = self.Qx.cpu().numpy()
        Ktilde = (self.Qx.T @ self.Qy).cpu().numpy() @ self.A.cpu().numpy() \
            @ la.pinv(self.Gx.cpu().numpy())
        evals, evecs = la.eig(Ktilde)
        modes = Qx @ evecs
        return modes, evals
