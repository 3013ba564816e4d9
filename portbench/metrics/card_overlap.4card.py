"""``card_overlap.4card``: cards at work at once, on average over the
traced window's busy time: the sum of the cards' busy seconds (each the
union of its kernel, copy and memset intervals) over the seconds in which
any card is busy.  1.0 where the cards take turns, the number of cards
where all work at once."""
from portbench.devtrace import busy_by_card, union

HOOKS = []


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr["device"]:
        return None
    lo, hi = tr["window"]
    anyone = sum(t - s for s, t in union(
        [(s, t) for _, s, t in tr["device"]], lo, hi))
    if anyone <= 0:
        return None
    return sum(busy_by_card(tr)) / anyone
