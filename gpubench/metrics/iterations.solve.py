"""Solver iterations per solve (``SolveInfo.iterations``), mean over the
traced window's solves."""


def read(rec: dict):
    if rec.get("loop") != "solve" or not rec.get("units"):
        return None
    return rec["iterations"] / rec["units"]
