"""``launches_per_request.explore``: kernels the card ran in the server's
traced window, over the requests answered in it."""
from portbench.devtrace import is_kernel

HOOKS = []


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr["device"] or not rec["jobs"]:
        return None
    lo, hi = tr["window"]
    n = sum(1 for name, s, _ in tr["device"]
            if is_kernel(name) and lo <= s <= hi)
    return n / rec["jobs"]
