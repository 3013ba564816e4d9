"""``read_span_s.series``: seconds a plotfile inside the program's own
``read.plotfile`` spans (their union, any thread), over the jobs finished
in the traced window: the read timed from inside ``load_plotfile_fabs``,
where ``read_s.series`` times it from the benchmark's side."""
from portbench import program

HOOKS = program.HOOKS


def read(rec):
    tel = program.telemetry(rec)
    if tel is None or not rec["jobs"]:
        return None
    return program.union_s(tel, lambda n: n == "read.plotfile") / rec["jobs"]
