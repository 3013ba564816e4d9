"""``tool_self_s.series``: self time a plotfile of the program's
``tool.<tool>`` spans: their union less the part of it their descendant
spans cover (reads, assembly, fills, stats, marching cubes, writes), over
the jobs finished in the traced window; the tools' own host dispatch."""
from portbench import program

HOOKS = program.HOOKS


def read(rec):
    tel = program.telemetry(rec)
    if tel is None or not rec["jobs"]:
        return None
    return program.self_s(tel, lambda n: n.startswith("tool.")) / rec["jobs"]
