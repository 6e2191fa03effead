"""Operator algebra on tensors: the LinearMaps.jl-equivalence surface.

Counterpart of ``blocksparse_tpu/core/operator.py``:

- ``A @ x`` / ``A.mv(x)``        : SpMV
- ``A @ X`` / ``A.mm(X)``        : multi-RHS SpMM
- ``A.axpby(x, y, alpha, beta)`` : functional 5-arg ``mul!`` -> alpha*A@x + beta*y
- ``A.apply(x, transpose=, conj=)``: the product with explicit mode flags
- ``A.T`` / ``A.H`` / ``A.conj()``: lazy wrappers (flag flips; the index
                                   tables swap roles, no data movement);
                                   ``A.transpose()`` / ``A.adjoint()`` too
- ``A.matvec_closure()``          : a plain ``x -> A @ x`` callable
- ``a * A``, ``A + B``, ``A @ B``: scaled / summed / composed operators

Operands are ``torch.Tensor``s (a numpy array is taken as a CPU tensor).
A product on a tensor that lives on another device than the operator raises
``ValueError``; nothing is moved implicitly.  Gradients flow through the
kernels' ``torch.autograd.Function``s.

Divergence (deliberate, documented): the 5-arg path follows the strict BLAS
rule that a *static* beta == 0 (a Python number) overwrites y (no NaN
propagation), unlike the reference's ``y .*= beta`` which propagates NaN.
A tensor beta multiplies through like the reference.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "LinearOperator",
    "AdjointOperator",
    "TransposeOperator",
    "ConjOperator",
    "ScaledOperator",
    "SumOperator",
    "ComposedOperator",
]

_SCALARS = (int, float, complex)


def _is_static_zero(v) -> bool:
    return isinstance(v, _SCALARS) and v == 0


def _is_static_one(v) -> bool:
    return isinstance(v, _SCALARS) and v == 1


def _is_scalar(v) -> bool:
    return isinstance(v, _SCALARS) or (
        isinstance(v, torch.Tensor) and v.ndim == 0)


def as_tensor(x) -> torch.Tensor:
    """A tensor as it is; anything else (numpy, lists) as a CPU tensor."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


class LinearOperator:
    """Abstract linear operator with lazy adjoint/transpose and composition."""

    # subclasses provide: shape -> (m, n), dtype, _apply(x, transpose, conj)

    @property
    def shape(self) -> tuple[int, int]:
        raise NotImplementedError

    @property
    def dtype(self) -> torch.dtype:
        raise NotImplementedError

    def _apply(self, x, transpose: bool, conj: bool):
        """Apply the operator (or its transpose/conjugate) to x.

        x: [n] or [n, r].  Returns [m] or [m, r] accordingly.
        """
        raise NotImplementedError

    # -- core products ------------------------------------------------------
    def mv(self, x):
        x = as_tensor(x)
        if x.ndim != 1:
            raise ValueError(f"mv expects a vector, got shape {tuple(x.shape)}")
        if x.shape[0] != self.shape[1]:
            raise ValueError(
                f"operand length {x.shape[0]} != operator ncols {self.shape[1]}"
            )
        return self._apply(x, False, False)

    def mm(self, X):
        X = as_tensor(X)
        if X.ndim != 2:
            raise ValueError(f"mm expects a matrix, got shape {tuple(X.shape)}")
        if X.shape[0] != self.shape[1]:
            raise ValueError(
                f"operand rows {X.shape[0]} != operator ncols {self.shape[1]}"
            )
        return self._apply(X, False, False)

    def axpby(self, x, y, alpha=1, beta=0):
        """Functional 5-arg mul!: returns alpha * (A @ x) + beta * y.

        A static beta == 0 overwrites (strict BLAS; see module docstring).
        """
        x = as_tensor(x)
        if x.shape[0] != self.shape[1]:
            raise ValueError(
                f"operand length {x.shape[0]} != operator ncols {self.shape[1]}"
            )
        ax = self._apply(x, False, False)
        if not _is_static_one(alpha):
            ax = alpha * ax
        if _is_static_zero(beta):
            return ax
        return ax + beta * as_tensor(y)

    # -- python operator sugar ---------------------------------------------
    def __matmul__(self, other):
        if isinstance(other, LinearOperator):
            return ComposedOperator(self, other)
        other = as_tensor(other)
        if other.ndim == 1:
            return self.mv(other)
        if other.ndim == 2:
            return self.mm(other)
        raise ValueError(f"cannot multiply operator by array of ndim {other.ndim}")

    def apply(self, x, *, transpose: bool = False, conj: bool = False):
        """The product with explicit mode flags (``A @ x``, ``A.T @ x``,
        ``A.conj() @ x`` or ``A.H @ x``)."""
        return self._apply(as_tensor(x), transpose, conj)

    def __mul__(self, other):
        if _is_scalar(other):
            return ScaledOperator(other, self)
        return self.__matmul__(other)

    def __rmul__(self, other):
        if _is_scalar(other):
            return ScaledOperator(other, self)
        return NotImplemented

    def __add__(self, other):
        if isinstance(other, LinearOperator):
            return SumOperator(self, other)
        return NotImplemented

    def __sub__(self, other):
        if isinstance(other, LinearOperator):
            return SumOperator(self, ScaledOperator(-1, other))
        return NotImplemented

    def __neg__(self):
        return ScaledOperator(-1, self)

    # -- lazy wrappers ------------------------------------------------------
    @property
    def T(self) -> "LinearOperator":
        return TransposeOperator(self)

    @property
    def H(self) -> "LinearOperator":
        return AdjointOperator(self)

    def adjoint(self) -> "LinearOperator":
        return self.H

    def transpose(self) -> "LinearOperator":
        return self.T

    def conj(self) -> "LinearOperator":
        return ConjOperator(self)

    # -- materialization ----------------------------------------------------
    def todense(self) -> torch.Tensor:
        """Materialize as a dense tensor (A @ I)."""
        eye = torch.eye(self.shape[1], dtype=self.dtype, device=self.device)
        return self.mm(eye)

    def matvec_closure(self):
        """A plain ``x -> A @ x`` callable, for solvers that take one."""
        return lambda x: self.__matmul__(x)


class _WrappedOperator(LinearOperator):
    """Base for single-child lazy wrappers."""

    def __init__(self, op: LinearOperator):
        self.op = op

    @property
    def dtype(self):
        return self.op.dtype

    @property
    def device(self):
        return self.op.device

    @property
    def schedule(self):
        return self.op.schedule


class TransposeOperator(_WrappedOperator):
    """Lazy transpose."""

    @property
    def shape(self):
        m, n = self.op.shape
        return (n, m)

    def _apply(self, x, transpose, conj):
        return self.op._apply(x, not transpose, conj)

    @property
    def T(self):
        return self.op

    @property
    def H(self):
        return ConjOperator(self.op)


class AdjointOperator(_WrappedOperator):
    """Lazy adjoint."""

    @property
    def shape(self):
        m, n = self.op.shape
        return (n, m)

    def _apply(self, x, transpose, conj):
        return self.op._apply(x, not transpose, not conj)

    @property
    def H(self):
        return self.op

    @property
    def T(self):
        return ConjOperator(self.op)


class ConjOperator(_WrappedOperator):
    """Lazy elementwise conjugate: conj(A) = (A.H).T."""

    @property
    def shape(self):
        return self.op.shape

    def _apply(self, x, transpose, conj):
        return self.op._apply(x, transpose, not conj)

    def conj(self):
        return self.op


class ScaledOperator(LinearOperator):
    """alpha * A."""

    def __init__(self, alpha, op: LinearOperator):
        self.alpha = alpha
        self.op = op

    @property
    def shape(self):
        return self.op.shape

    @property
    def dtype(self):
        return torch.result_type(torch.empty(0, dtype=self.op.dtype),
                                 self.alpha)

    @property
    def device(self):
        return self.op.device

    def _apply(self, x, transpose, conj):
        a = self.alpha
        if conj:
            a = a.conj() if isinstance(a, torch.Tensor) else np.conj(a).item()
        return a * self.op._apply(x, transpose, conj)


class SumOperator(LinearOperator):
    """A + B."""

    def __init__(self, a: LinearOperator, b: LinearOperator):
        if a.shape != b.shape:
            raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
        self.a = a
        self.b = b

    @property
    def shape(self):
        return self.a.shape

    @property
    def dtype(self):
        return torch.promote_types(self.a.dtype, self.b.dtype)

    @property
    def device(self):
        return self.a.device

    def _apply(self, x, transpose, conj):
        return self.a._apply(x, transpose, conj) + self.b._apply(x, transpose, conj)


class ComposedOperator(LinearOperator):
    """A @ B."""

    def __init__(self, a: LinearOperator, b: LinearOperator):
        if a.shape[1] != b.shape[0]:
            raise ValueError(f"inner dim mismatch: {a.shape} @ {b.shape}")
        self.a = a
        self.b = b

    @property
    def shape(self):
        return (self.a.shape[0], self.b.shape[1])

    @property
    def dtype(self):
        return torch.promote_types(self.a.dtype, self.b.dtype)

    @property
    def device(self):
        return self.a.device

    def _apply(self, x, transpose, conj):
        if transpose:
            # (A B)^T = B^T A^T
            return self.b._apply(self.a._apply(x, True, conj), True, conj)
        return self.a._apply(self.b._apply(x, False, conj), False, conj)
