"""``write_span_s.series``: seconds a plotfile inside the program's
``write.<kind>`` (MEF, text, plotfile) and ``writeback.wait`` spans (their
union, any thread, the write-back thread's included), over the jobs
finished in the traced window."""
from portbench import program

HOOKS = program.HOOKS


def read(rec):
    tel = program.telemetry(rec)
    if tel is None or not rec["jobs"]:
        return None
    return program.union_s(tel, lambda n: n.startswith("write.")
                           or n == "writeback.wait") / rec["jobs"]
