"""``device_idle.series``: percent of the traced window in which no
kernel, copy or memset runs on the card (one minus the union of the
device intervals)."""
from portbench.devtrace import busy_s

HOOKS = []


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr["device"]:
        return None
    lo, hi = tr["window"]
    return 100.0 * (1.0 - busy_s(tr) / (hi - lo))
