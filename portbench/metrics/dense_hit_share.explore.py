"""``dense_hit_share.explore``: percent of the server's dense-state
requests (``Session.dense``) in the traced window served without
assembling host FABs: ``session.dense_hit`` over ``session.dense_hit``
plus ``session.dense_build``."""
from portbench import program

HOOKS = program.HOOKS


def read(rec):
    tel = program.telemetry(rec)
    if tel is None:
        return None
    hit = tel["counters"].get("session.dense_hit", 0)
    built = tel["counters"].get("session.dense_build", 0)
    if not hit + built:
        return None
    return 100.0 * hit / (hit + built)
