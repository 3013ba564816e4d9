"""``extract_ms.explore``: host milliseconds inside the program's own
``isosurface.<stage>`` ranges (their union), per isosurface request
answered in the traced window."""
from portbench.devtrace import union

HOOKS = []


def read(rec):
    tr = rec.get("trace")
    n = rec["kinds"].get("isosurface", 0)
    if not tr or not tr["ranges"] or not n:
        return None
    lo, hi = tr["window"]
    return 1e3 * sum(t - s for s, t in union(
        [(s, t) for _, s, t in tr["ranges"]], lo, hi)) / n
