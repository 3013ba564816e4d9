"""``read_mb_per_request.explore``: megabytes (1e6 bytes) of FABs the
server read from plotfiles (``read.bytes``) over the requests it ran
(``serve.requests``), in the traced window: 0 where the session serves
every request from memory."""
from portbench import program

HOOKS = program.HOOKS


def read(rec):
    tel = program.telemetry(rec)
    n = tel["counters"].get("serve.requests", 0) if tel else 0
    if not n:
        return None
    return tel["counters"].get("read.bytes", 0) / 1e6 / n
