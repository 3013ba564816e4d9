"""``serve_ms.explore``: milliseconds a request of the server's own work
around the tools: the self time of the ``serve.request`` spans (socket,
JSON, output capture, less the tool's and the settling flush's spans) over
the requests it ran (``serve.requests``), in the traced window."""
from portbench import program

HOOKS = program.HOOKS


def read(rec):
    tel = program.telemetry(rec)
    n = tel["counters"].get("serve.requests", 0) if tel else 0
    if not n:
        return None
    return 1e3 * program.self_s(tel, lambda s: s == "serve.request") / n
