"""Iterative solvers over the block-sparse operator algebra, on tensors.

Counterpart of ``blocksparse_tpu/solvers.py``: :func:`cg`, :func:`bicgstab`
and :func:`gmres` take an operator of this package (or any of its lazy
wrappers), a callable or a dense matrix, with the JAX signatures and
defaults, run the same recurrences (CG with ``vdot``; BiCGStab with the
unconjugated shadow residual and its ``stalled`` guard; GMRES(m) with CGS2,
Givens rotations, the lucky-breakdown test and the identity-padded
back-substitution), apply ``M`` as a left preconditioner with SciPy's
semantics, and report a :class:`SolveInfo` whose residual is the true
``||b - A x||``.

Devices.  ``b``, ``x0`` and every iterate live on the solve's device, which
is the operator's, or a dense tensor ``A``'s; for a dense numpy or a
callable ``A`` it is ``b``'s where ``b`` is a tensor, else the card (the CPU
is used only when the caller's tensors lie there).  ``b`` and ``x0`` are
moved onto that device, as is a dense ``M`` given as numpy (an operator or
a tensor ``M`` stays where it lies).  A ``b`` whose dtype differs from the
operator's raises ``TypeError``, as the formats' products do.

The loop.  The JAX solvers are ``lax.while_loop`` programs whose condition
is tested on the device.  Eager PyTorch has no such loop, and a Python loop
that reads its condition with ``.item()`` waits for the device on every
iteration.  So each solver runs *masked iterations checked in chunks*: a
0-dim bool tensor ``active`` on the device holds the JAX ``cond``; every
state update is gated by ``torch.where(active, new, old)`` (never by a 0/1
multiply: a frozen step may divide by a vanished ``rz`` or ``omega``, and
``0 * inf`` is NaN); the iteration counter grows by ``active``; and the host
reads the flag once per ``CHUNK`` iterations, the first time after the
first chunk.  Frozen steps change nothing, so the iterate and the count are
the JAX ones; the cost is at most ``CHUNK - 1`` wasted iterations after the
converging one, and a whole chunk of them where the initial state already
meets the test (``b = 0``, an exact ``x0``).  GMRES reads its flags at
the chunk boundaries of each restart cycle, the last of which ends the
cycle and also tells whether another cycle follows.

``CHUNK = 8``: an eager iteration spends more time enqueueing on the host
than the card spends running it (two products and about ten vector
operations), so the queue is short whenever the host reads and a read costs
little more than its own round trip; eight keeps the waste after
convergence to at most eight iterations while reading once every eight.
``HOST_CHECKS`` counts the host reads, as the kernel wrappers count their
launches.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .core.operator import LinearOperator, as_tensor
from .formats.block_sparse import _resolve_device

__all__ = ["SolveInfo", "cg", "bicgstab", "gmres", "as_matvec"]

CHUNK = 8
HOST_CHECKS = 0


class SolveInfo(NamedTuple):
    """Outcome of an iterative solve (0-dim tensors on the solve's device)."""

    iterations: torch.Tensor  # int32 number of iterations performed
    residual: torch.Tensor  # final ||b - A x|| (the true residual)
    converged: torch.Tensor  # bool: residual <= max(tol*||b||, atol)


def _operand(A, default=None):
    """``(x -> A @ x, its device)`` for an operator-like ``A``: an operator
    or a dense tensor brings its own device; a dense matrix in numpy (or
    lists) becomes a tensor on ``default``, the card unless given; a
    callable runs wherever its operand lies, reported as ``default``."""
    if isinstance(A, LinearOperator):
        return A.apply, A.device
    if callable(A) and not hasattr(A, "ndim"):
        return A, default
    if not isinstance(A, torch.Tensor):
        A = as_tensor(A).to(_resolve_device("cuda") if default is None
                            else default)
    return (lambda x: A @ x), A.device


def as_matvec(A) -> Callable:
    """Normalize an operator-like object to an ``x -> A @ x`` callable.

    Accepts a :class:`LinearOperator` (or any of its lazy wrappers), a
    callable, or a dense matrix (a tensor stays on its device; numpy goes
    to the card).
    """
    return _operand(A)[0]


def _setup(A, b, x0, M):
    """``(A's matvec, M's, b, x)`` on the solve's device: the operator's or
    a dense tensor ``A``'s; for a numpy or callable ``A``, a tensor ``b``'s;
    else the card."""
    mv, device = _operand(A, b.device if isinstance(b, torch.Tensor) else None)
    if device is None:
        device = _resolve_device("cuda")
    pre = (lambda x: x) if M is None else _operand(M, device)[0]
    b = as_tensor(b).to(device)
    if isinstance(A, LinearOperator) and b.dtype != A.dtype:
        raise TypeError(f"b dtype {b.dtype} != operator dtype {A.dtype}")
    x = torch.zeros_like(b) if x0 is None else as_tensor(x0).to(device)
    return mv, pre, b, x


def _real_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.empty(0, dtype=dtype).real.dtype


def _norm(v):
    return torch.linalg.vector_norm(v)


def _tolerance(b, tol, atol):
    return torch.clamp(tol * _norm(b), min=atol).to(_real_dtype(b.dtype))


def _host_read(flags: torch.Tensor):
    """The one place the solvers wait for the device: read ``flags`` (a bool
    tensor) on the host."""
    global HOST_CHECKS
    HOST_CHECKS += 1
    return flags.tolist()


def _masked_loop(state, body, cond, maxiter):
    """``lax.while_loop(cond, body, (0, *state))`` as masked iterations read
    once per ``CHUNK``: returns ``(k, state)``, ``k`` an int32 tensor."""
    k = torch.zeros((), dtype=torch.int32, device=state[0].device)
    active = cond(k, state)
    steps = 0
    while steps < maxiter:
        for _ in range(min(CHUNK, maxiter - steps)):
            new = body(state)
            state = tuple(torch.where(active, n, o) for n, o in zip(new, state))
            k = k + active.to(torch.int32)
            active = cond(k, state)
        steps += CHUNK
        if steps >= maxiter or not _host_read(active):
            break
    return k, state


def cg(A, b, *, x0=None, tol=1e-6, atol=0.0, maxiter=None, M=None):
    """Preconditioned conjugate gradients for Hermitian positive-definite A.

    Returns ``(x, SolveInfo)``.  ``M`` is a left preconditioner approximating
    ``A^{-1}`` (operator, callable, or dense matrix).
    """
    mv, pre, b, x = _setup(A, b, x0, M)
    if maxiter is None:
        maxiter = 10 * b.shape[0]
    thresh = _tolerance(b, tol, atol)

    r0 = b - mv(x)
    z0 = pre(r0)

    def cond(k, s):
        return (k < maxiter) & (_norm(s[1]) > thresh)

    def body(s):
        x, r, p, rz = s
        ap = mv(p)
        alpha = rz / torch.vdot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = pre(r)
        rz_new = torch.vdot(r, z)
        p = z + (rz_new / rz) * p
        return (x, r, p, rz_new)

    k, (x, *_) = _masked_loop((x, r0, z0, torch.vdot(r0, z0)), body, cond,
                              maxiter)
    res = _norm(b - mv(x))
    return x, SolveInfo(k, res, res <= thresh)


def bicgstab(A, b, *, x0=None, tol=1e-6, atol=0.0, maxiter=None, M=None):
    """Preconditioned BiCGStab for general (non-symmetric) square A.

    Returns ``(x, SolveInfo)``.  Breaks down gracefully: rho or omega ~ 0
    stalls the iteration, leaving the best x so far, reported through
    ``converged``.
    """
    mv, pre, b, x = _setup(A, b, x0, M)
    if maxiter is None:
        maxiter = 10 * b.shape[0]
    thresh = _tolerance(b, tol, atol)

    r0 = b - mv(x)
    rhat = r0  # shadow residual, fixed
    one = torch.ones((), dtype=b.dtype, device=b.device)
    eps = torch.finfo(_real_dtype(b.dtype)).tiny * 16
    # state: (x, r, p, v, rho, alpha, omega, stalled)
    state = (x, r0, torch.zeros_like(b), torch.zeros_like(b), one, one, one,
             torch.zeros((), dtype=torch.bool, device=b.device))

    def cond(k, s):
        return (k < maxiter) & (_norm(s[1]) > thresh) & ~s[-1]

    def body(s):
        x, r, p, v, rho, alpha, omega, _ = s
        rho_new = torch.vdot(rhat, r)
        stalled = (rho_new.abs() < eps) | (omega.abs() < eps)
        # guard the divisions so a breakdown never pollutes the iterate;
        # when stalled the old state is kept and the loop exits next cond.
        def safe(d):
            return torch.where(stalled, torch.ones_like(d), d)
        beta = (rho_new / safe(rho)) * (alpha / safe(omega))
        p_new = r + beta * (p - omega * v)
        phat = pre(p_new)
        v_new = mv(phat)
        alpha_new = rho_new / safe(torch.vdot(rhat, v_new))
        sres = r - alpha_new * v_new
        shat = pre(sres)
        t = mv(shat)
        omega_new = torch.vdot(t, sres) / safe(torch.vdot(t, t))
        x_new = x + alpha_new * phat + omega_new * shat
        r_new = sres - omega_new * t
        kept = tuple(torch.where(stalled, old, new) for old, new in zip(
            s[:-1], (x_new, r_new, p_new, v_new, rho_new, alpha_new,
                     omega_new)))
        return kept + (stalled,)

    k, (x, *_) = _masked_loop(state, body, cond, maxiter)
    res = _norm(b - mv(x))
    return x, SolveInfo(k, res, res <= thresh)


def gmres(A, b, *, x0=None, tol=1e-6, atol=0.0, restart=20, maxiter=None,
          M=None):
    """Restarted GMRES(m): Arnoldi + Givens, as the JAX package runs it.

    Per restart cycle the Krylov basis is built with classical Gram-Schmidt
    and one reorthogonalization pass (CGS2: two [m+1, n] matrix-vector
    products per step), the Hessenberg column is rotated into triangular
    form with Givens rotations so the residual norm is tracked for free, and
    the cycle ends early on convergence or lucky breakdown.

    ``M`` is a LEFT preconditioner approximating ``A^{-1}``: the iteration
    runs on ``M A x = M b`` and converges when the *preconditioned* residual
    meets ``max(tol * ||M b||, atol)`` (SciPy semantics).  The returned
    ``SolveInfo`` reports the TRUE residual ``||b - A x||`` and the number
    of inner (matvec) iterations performed; ``converged`` reflects the
    preconditioned test.  Real and complex dtypes.

    Returns ``(x, SolveInfo)``.
    """
    mv, pre, b, x = _setup(A, b, x0, M)
    x = x.to(b.dtype)
    n, dt, dev = b.shape[0], b.dtype, b.device
    m = int(min(restart, n))
    if maxiter is None:
        maxiter = 10 * n
    rdt = _real_dtype(dt)
    thresh = torch.clamp(tol * _norm(pre(b)), min=atol).to(rdt)
    eps = torch.finfo(rdt).eps
    zero = torch.zeros((), dtype=dt, device=dev)
    one = torch.ones((), dtype=dt, device=dev)
    eye = torch.eye(m, dtype=dt, device=dev)
    idx = torch.arange(m, device=dev)

    it = torch.zeros((), dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    more = maxiter > 0
    while more:
        r = pre(b - mv(x))
        beta = _norm(r).to(rdt)
        V = torch.zeros((m + 1, n), dtype=dt, device=dev)
        V[0] = torch.where(beta > 0, r / beta.to(dt), r)
        H = torch.zeros((m + 1, m), dtype=dt, device=dev)  # rotated columns
        G = torch.zeros((m, 2, 2), dtype=dt, device=dev)  # the rotations
        g = torch.zeros((m + 1,), dtype=dt, device=dev)
        g[0] = beta.to(dt)
        j = torch.zeros((), dtype=torch.int32, device=dev)
        res, brk = beta, torch.zeros((), dtype=torch.bool, device=dev)

        def inner_cond():
            return (j < m) & (res > thresh) & ~brk & (it + j < maxiter)

        active = inner_cond()
        # while active, the host step jj equals the device count j
        for jj in range(m):
            w = pre(mv(V[jj]))
            # CGS2: rows > jj of V are zero, so the full-matrix projections
            # are exact and need no masking
            h1 = V.conj() @ w
            w = w - V.T @ h1
            h2 = V.conj() @ w
            w = w - V.T @ h2
            h = h1 + h2
            hnorm = _norm(w).to(rdt)
            # lucky breakdown: the Krylov space is invariant; finish this
            # column (its rotation is trivial) and end the cycle
            brk_new = hnorm <= eps * 100 * (_norm(h).to(rdt) + 1)
            v_next = torch.where(brk_new, torch.zeros_like(w),
                                 w / torch.where(brk_new, 1.0, hnorm).to(dt))
            h[jj + 1] = torch.where(brk_new, 0.0, hnorm).to(dt)
            # apply the previous rotations to the new column
            for i in range(jj):
                h[i:i + 2] = G[i] @ h[i:i + 2]
            # new rotation zeroing h[jj + 1]
            a_, b_ = h[jj], h[jj + 1]
            denom = torch.sqrt(a_.abs() ** 2 + b_.abs() ** 2)
            safe = torch.where(denom > 0, denom, 1.0).to(rdt)
            c_new = (a_.abs() / safe).to(dt)
            phase = torch.where(a_.abs() > 0, a_ / a_.abs().to(dt), one)
            s_new = phase * b_.conj() / safe.to(dt)
            h[jj] = c_new * a_ + s_new * b_
            h[jj + 1] = zero
            rot = torch.stack([torch.stack([c_new, s_new]),
                               torch.stack([-s_new.conj(), c_new.conj()])])
            gj = g[jj]
            g_new = torch.stack([c_new * gj, -s_new.conj() * gj])
            res_new = g_new[1].abs().to(rdt)

            V[jj + 1] = torch.where(active, v_next, V[jj + 1])
            H[:, jj] = torch.where(active, h, H[:, jj])
            G[jj] = torch.where(active, rot, G[jj])
            g[jj:jj + 2] = torch.where(active, g_new, g[jj:jj + 2])
            res = torch.where(active, res_new, res)
            brk = torch.where(active, brk_new, brk)
            j = j + active.to(torch.int32)
            active = inner_cond()
            if (jj + 1) % CHUNK == 0 or jj + 1 == m:
                # another cycle follows iff (it + j < maxiter) & ~done, both
                # fixed once the cycle has stopped
                on, more = _host_read(torch.stack(
                    [active, (it + j < maxiter) & (res > thresh)]))
                if not on:
                    break

        # back-substitution on the rotated (triangular) H: pad unused rows
        # with an identity diagonal so y[j:] = 0
        used = idx < j
        R = torch.where(used[:, None] & used[None, :], H[:m, :m], eye)
        rhs = torch.where(used, g[:m], zero)
        y = torch.linalg.solve_triangular(R, rhs[:, None], upper=True)[:, 0]
        x = x + V[:m].T @ y
        done = res <= thresh
        it = it + j
        more = more and m > 0

    res_true = _norm(b - mv(x))
    return x, SolveInfo(it, res_true, done)
