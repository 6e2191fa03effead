"""Host reads of the solvers' convergence flag (``solvers.HOST_CHECKS``)
per solve."""


def read(rec: dict):
    if rec.get("loop") != "solve" or not rec.get("units"):
        return None
    return rec["host_checks"] / rec["units"]
