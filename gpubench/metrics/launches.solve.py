"""Kernel launches of the port's wrappers (their counters) per solver
iteration as ``SolveInfo.iterations`` reports them: what the route decision
sends the operator's and the preconditioner's products to, with the masked
iterations run after convergence counted against the useful ones."""


def read(rec: dict):
    if rec.get("loop") != "solve" or not rec.get("iterations"):
        return None
    return sum(rec["launches"].values()) / rec["iterations"]
