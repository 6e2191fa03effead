"""Plain PyTorch reference of the BEM near-field operator and its solves.

It imports nothing of the program under test.  From the benchmark's inputs
alone (the jittered points, the leaf ranges, the near pairs and the
wavenumber) it works the operator out again: every block is recomputed
from the points in float64 / complex128, the self-term from its closed
form, the block-Jacobi inverses from its own diagonal blocks.
Blocks are padded to the largest leaf and applied in batches, so nothing
larger than one batch of blocks is held.

``precision="float64"`` is the reference.  ``precision="tf32"`` is the
control: the same arithmetic with every product's operands rounded to
TF32 (10 explicit mantissa bits, round to nearest even) and summed in
float32, as TF32 tensor cores compute; the solvers' vectors are then float32
/ complex64.  It is the nearest precision below the configurations'
float32 at ``precision="highest"``.
"""

from __future__ import annotations

import math

import torch

# blocks per batch: 1024 padded 128 x 128 complex128 blocks are 268 MB
BATCH_BLOCKS = 1024


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 / complex64 ``t`` rounded to TF32, to nearest even."""
    if t.is_complex():
        return torch.complex(round_tf32(t.real.contiguous()),
                             round_tf32(t.imag.contiguous()))
    i = t.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


class BemReference:
    """The operator ``A = 1/2 I - K`` on the near field: the double layer
    of the unit sphere, ``K(r) = exp(i k r) (i k r - 1) / (8 pi r)``, at
    the equal weights ``w = 4 pi / n`` (its real part for a real operator),
    ``c`` the self-term on the diagonal."""

    def __init__(self, points: torch.Tensor, starts, sizes, pairs, *,
                 k: float, complex_: bool):
        dev = points.device
        self.device = dev
        self.n = int(points.shape[0])
        self.k = float(k)
        self.complex_ = bool(complex_)
        self.w = 4 * math.pi / self.n
        starts = torch.as_tensor(starts, dtype=torch.int64, device=dev)
        sizes = torch.as_tensor(sizes, dtype=torch.int64, device=dev)
        self.T = int(sizes.max())
        ar = torch.arange(self.T, device=dev)
        self.mask = ar[None, :] < sizes[:, None]  # [L, T]
        idx = (starts[:, None] + ar[None, :]).clamp_max(self.n - 1)
        self.idx = torch.where(self.mask, idx, torch.zeros_like(idx))
        self.P = points.to(torch.float64)[self.idx]  # [L, T, 3]
        pairs = torch.as_tensor(pairs, dtype=torch.int64, device=dev)
        self.I, self.J = pairs[:, 0].contiguous(), pairs[:, 1].contiguous()
        self.L = int(sizes.numel())
        # 1/2 less K over the point's own patch, a disk of radius a:
        # (1/4) int_0^a exp(ikr) (ikr - 1) dr, by Simpson's rule on the
        # closed form's integrand (its error is far below float32's)
        a = math.sqrt(self.w / math.pi)
        r = torch.linspace(0, a, 2001, dtype=torch.float64)
        f = torch.polar(torch.ones_like(r), self.k * r) * torch.complex(
            -torch.ones_like(r), self.k * r)
        wts = torch.ones_like(r)
        wts[1:-1:2], wts[2:-1:2] = 4, 2
        c = 0.5 - 0.25 * complex((f * wts).sum() * (a / 2000) / 3)
        self.self_term = c if self.complex_ else c.real

    # -- blocks ---------------------------------------------------------------
    def _blocks(self, I, J, diagonal: bool) -> torch.Tensor:
        """Padded blocks ``[B, T, T]`` between leaves ``I`` and ``J``
        (float64 / complex128; zero in the padding; on a diagonal block the
        self-term on its diagonal)."""
        r = torch.cdist(self.P[I], self.P[J])
        live = self.mask[I][:, :, None] & self.mask[J][:, None, :]
        if diagonal:
            eye = torch.eye(self.T, dtype=torch.bool, device=self.device)
            live = live & ~eye
        r = torch.where(live, r, torch.ones_like(r))
        kr = self.k * r
        g = (self.w / (8 * math.pi * r)) * torch.complex(
            torch.cos(kr) + kr * torch.sin(kr), torch.sin(kr) - kr * torch.cos(kr))
        g = g if self.complex_ else g.real
        g = torch.where(live, g, torch.zeros_like(g))
        if diagonal:
            d = self.mask[I][:, :, None] & torch.eye(
                self.T, dtype=torch.bool, device=self.device)
            g = torch.where(d, torch.full_like(g, self.self_term), g)
        return g

    def _batches(self):
        """``(I, J, diagonal)``: the diagonal leaves, then the pairs."""
        ar = torch.arange(self.L, device=self.device)
        for b0 in range(0, self.L, BATCH_BLOCKS):
            s = ar[b0:b0 + BATCH_BLOCKS]
            yield s, s, True
        for b0 in range(0, self.I.numel(), BATCH_BLOCKS):
            yield (self.I[b0:b0 + BATCH_BLOCKS], self.J[b0:b0 + BATCH_BLOCKS],
                   False)

    # -- products ---------------------------------------------------------------
    def _padded(self, X: torch.Tensor) -> torch.Tensor:
        Xp = X[self.idx]
        return torch.where(self.mask[:, :, None], Xp, torch.zeros_like(Xp))

    def _compute_dtype(self, precision: str) -> torch.dtype:
        if precision == "float64":
            return torch.complex128 if self.complex_ else torch.float64
        if precision == "tf32":
            return torch.complex64 if self.complex_ else torch.float32
        raise ValueError(f"unknown precision {precision!r}")

    def _cast(self, t: torch.Tensor, precision: str) -> torch.Tensor:
        t = t.to(self._compute_dtype(precision))
        return round_tf32(t) if precision == "tf32" else t

    def apply(self, X: torch.Tensor, precision: str = "float64") -> torch.Tensor:
        """``A @ X`` for ``X`` of ``[n]`` or ``[n, r]``."""
        vec = X.ndim == 1
        X = X[:, None] if vec else X
        with _ieee_matmul():
            Xp = self._cast(self._padded(X), precision)
            Y = torch.zeros_like(Xp)
            for I, J, diagonal in self._batches():
                G = self._cast(self._blocks(I, J, diagonal), precision)
                Y.index_add_(0, I, torch.bmm(G, Xp[J]))
                if not diagonal:
                    Y.index_add_(0, J, torch.bmm(G.transpose(1, 2), Xp[I]))
        Y = Y[self.mask]
        return Y[:, 0] if vec else Y

    def jacobi_inverses(self) -> torch.Tensor:
        """The inverses of the diagonal leaf blocks, padded ``[L, T, T]``
        (float64 / complex128; identity rows and columns in the padding,
        zeroed after the inversion)."""
        out = []
        eye = torch.eye(self.T, device=self.device)
        for b0 in range(0, self.L, BATCH_BLOCKS):
            s = torch.arange(b0, min(b0 + BATCH_BLOCKS, self.L),
                             device=self.device)
            D = self._blocks(s, s, True)
            pad = (~self.mask[s])[:, :, None] & eye.bool()
            D = torch.where(pad, torch.ones_like(D), D)
            Dinv = torch.linalg.inv(D)
            live = self.mask[s][:, :, None] & self.mask[s][:, None, :]
            out.append(torch.where(live, Dinv, torch.zeros_like(Dinv)))
        return torch.cat(out)

    def apply_jacobi(self, inv: torch.Tensor, X: torch.Tensor,
                     precision: str = "float64") -> torch.Tensor:
        with _ieee_matmul():
            Xp = self._cast(self._padded(X), precision)
            Y = torch.bmm(self._cast(inv, precision), Xp)
        return Y[self.mask]

    # -- solves (columns independent, each with its own scalars) ----------
    def solve(self, solver: str, B: torch.Tensor, *, tol: float,
              maxiter: int, precision: str = "float64") -> torch.Tensor:
        """``solver`` ("cg" | "bicgstab") on each column of ``B`` with the
        block-Jacobi preconditioner, every product and the preconditioner
        in ``precision``; the iterate in that precision's vector type."""
        inv = self.jacobi_inverses()
        B = B.to(self._compute_dtype(precision))
        A = lambda V: self.apply(V, precision)  # noqa: E731
        M = lambda V: self.apply_jacobi(inv, V, precision)  # noqa: E731
        run = {"cg": _cg, "bicgstab": _bicgstab}[solver]
        return run(A, M, B, tol, maxiter)

    def relative_residuals(self, B: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
        """``||b - A x|| / ||b||`` per column, in float64."""
        dt = self._compute_dtype("float64")
        B, X = B.to(dt), X.to(dt)
        R = B - self.apply(X)
        return torch.linalg.vector_norm(R, dim=0) / torch.linalg.vector_norm(B, dim=0)


class _ieee_matmul:
    """TF32 off for matrix products inside: the reference's float64 needs
    none, and the control rounds its operands itself."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


def _dot(a, b):
    """Column-wise ``vdot(a, b)`` (the first argument conjugated)."""
    return (a.conj() * b).sum(dim=0)


def _cg(A, M, B, tol, maxiter):
    X = torch.zeros_like(B)
    R = B.clone()
    Z = M(R)
    P = Z.clone()
    rz = _dot(R, Z)
    thresh = tol * torch.linalg.vector_norm(B, dim=0)
    for _ in range(maxiter):
        active = torch.linalg.vector_norm(R, dim=0) > thresh
        if not bool(active.any()):
            break
        AP = A(P)
        alpha = torch.where(active, rz / _dot(P, AP), torch.zeros_like(rz))
        X = X + alpha * P
        R = R - alpha * AP
        Z = M(R)
        rz_new = _dot(R, Z)
        P = torch.where(active, Z + (rz_new / rz) * P, P)
        rz = torch.where(active, rz_new, rz)
    return X


def _bicgstab(A, M, B, tol, maxiter):
    X = torch.zeros_like(B)
    R = B.clone()
    rhat = R.clone()
    P = torch.zeros_like(B)
    V = torch.zeros_like(B)
    one = torch.ones(B.shape[1], dtype=B.dtype, device=B.device)
    rho, alpha, omega = one, one, one
    thresh = tol * torch.linalg.vector_norm(B, dim=0)
    tiny = torch.finfo(B.real.dtype).tiny * 16
    for _ in range(maxiter):
        rho_new = _dot(rhat, R)
        active = ((torch.linalg.vector_norm(R, dim=0) > thresh)
                  & (rho_new.abs() >= tiny) & (omega.abs() >= tiny))
        if not bool(active.any()):
            break
        safe = lambda d: torch.where(active, d, torch.ones_like(d))  # noqa: E731
        beta = (rho_new / safe(rho)) * (alpha / safe(omega))
        P_new = R + beta * (P - omega * V)
        Ph = M(P_new)
        V_new = A(Ph)
        alpha_new = rho_new / safe(_dot(rhat, V_new))
        S = R - alpha_new * V_new
        Sh = M(S)
        T = A(Sh)
        omega_new = _dot(T, S) / safe(_dot(T, T))
        keep = lambda new, old: torch.where(active, new, old)  # noqa: E731
        X = keep(X + alpha_new * Ph + omega_new * Sh, X)
        R = keep(S - omega_new * T, R)
        P, V = keep(P_new, P), keep(V_new, V)
        rho, alpha, omega = (keep(rho_new, rho), keep(alpha_new, alpha),
                             keep(omega_new, omega))
    return X
