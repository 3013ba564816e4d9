"""``device_idle.4card``: percent of the four cards' seconds in the traced
window in which no kernel, copy or memset runs: one minus the cards' mean
busy time (``devtrace.busy_s``) over the window."""
from portbench.devtrace import busy_s

HOOKS = []


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr["device"]:
        return None
    lo, hi = tr["window"]
    return 100.0 * (1.0 - busy_s(tr) / (hi - lo))
