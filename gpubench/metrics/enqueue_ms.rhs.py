"""Host time to enqueue one ``S @ X`` (host clock around the call, no
synchronize), mean over the traced window: the operator algebra, the
formats and the kernel wrappers."""


def read(rec: dict):
    if rec.get("loop") != "products" or not rec.get("enqueue_s"):
        return None
    return 1e3 * sum(rec["enqueue_s"]) / len(rec["enqueue_s"])
