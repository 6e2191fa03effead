"""The comparison that decides ``correct``.

Solves: the sampled solves' ``x`` against their ``b`` under the reference
operator, ``||b - A x|| / ||b||`` in float64 (``residual``, the worst
sampled solve), and the solves the program itself reported unconverged
(``unconverged``, exact: limit 0).  Products: the sampled ``Y = S @ X``
against the reference's float64 product of the same operand, the largest
entry error over the largest reference entry (``error``, the worst
sampled product).

The control puts the reference in the program's place at the nearest
precision below the configuration's (TF32 for float32 at "highest"):
the same right-hand sides or operands, judged the same way.
"""

from __future__ import annotations

import torch


def readings(ref, loop: str, answers: dict, rec: dict) -> dict:
    if loop == "solve":
        B = torch.stack(answers["b"], dim=1)
        X = torch.stack(answers["x"], dim=1)
        return {"residual": float(ref.relative_residuals(B, X).max()),
                "unconverged": rec["unconverged"]}
    return {"error": products_error(ref, answers["pool"], answers["operand"],
                                    answers["y"])}


def products_error(ref, pool, operand, ys) -> float:
    worst, exact = 0.0, {}
    for k, y in zip(operand, ys):
        if k not in exact:
            exact[k] = ref.apply(pool[k].to(torch.complex128 if pool[k].is_complex()
                                            else torch.float64))
        e = exact[k]
        worst = max(worst, float((y.to(e.dtype) - e).abs().max() / e.abs().max()))
    return worst


def control_readings(ref, loop: str, mix: dict, operands: list) -> dict:
    """The control's numbers: ``operands`` are the right-hand sides (solve)
    or the pool (products) a run of the same seed draws."""
    if loop == "solve":
        B = torch.stack(operands, dim=1)
        X = ref.solve(mix["solver"], B, tol=float(mix["tol"]),
                      maxiter=int(mix["maxiter"]), precision="tf32")
        return {"residual": float(ref.relative_residuals(B, X).max())}
    ys = [ref.apply(X, precision="tf32") for X in operands]
    return {"error": products_error(ref, operands, list(range(len(ys))), ys)}


def judge(numbers: dict, limits: dict) -> tuple:
    """``(correct, {name: {"value", "limit"}})``: every number at or under
    its limit; a number without a limit is not correct."""
    out, ok = {}, True
    for name, value in numbers.items():
        limit = limits.get(name, {}).get("limit")
        out[name] = {"value": value, "limit": limit}
        ok = ok and limit is not None and value <= limit
    return ok, out
