"""``assemble_s.series``: seconds a plotfile inside the program's
``assemble.host`` and ``assemble.h2d`` spans (their union): dense states
assembled on the host from the FABs and copied to the card, with the
masks' copies, over the jobs finished in the traced window."""
from portbench import program

HOOKS = program.HOOKS


def read(rec):
    tel = program.telemetry(rec)
    if tel is None or not rec["jobs"]:
        return None
    return program.union_s(
        tel, lambda n: n.startswith("assemble.")) / rec["jobs"]
