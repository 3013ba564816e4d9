"""``h2d_mb_per_request.explore``: megabytes (1e6 bytes) the server copied
from the host to the card to assemble dense states and their masks
(``h2d.bytes``) over the requests it ran (``serve.requests``), in the
traced window."""
from portbench import program

HOOKS = program.HOOKS


def read(rec):
    tel = program.telemetry(rec)
    n = tel["counters"].get("serve.requests", 0) if tel else 0
    if not n:
        return None
    return tel["counters"].get("h2d.bytes", 0) / 1e6 / n
