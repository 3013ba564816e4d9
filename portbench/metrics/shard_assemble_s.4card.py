"""``shard_assemble_s.4card``: seconds a plotfile inside the program's
``shard.assemble`` and ``shard.h2d`` spans (their union): the shard
windows assembled on the host from the FABs and copied to their cards,
over the jobs finished in the traced window.  None where the program has
no such span."""
from portbench import program

HOOKS = program.HOOKS
NAMES = ("shard.assemble", "shard.h2d")


def read(rec):
    tel = program.telemetry(rec)
    if tel is None or not rec["jobs"] or \
            not program.spans(tel, lambda n: n in NAMES):
        return None
    return program.union_s(tel, lambda n: n in NAMES) / rec["jobs"]
