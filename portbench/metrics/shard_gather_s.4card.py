"""``shard_gather_s.4card``: seconds a plotfile inside the program's
``shard.gather`` and ``shard.merge`` spans (their union): each window's
owned cells moved into the output on the first card, the gathered state
made, and the isosurface's windows merged by node key, over the jobs
finished in the traced window.  None where the program has no such
span."""
from portbench import program

HOOKS = program.HOOKS
NAMES = ("shard.gather", "shard.merge")


def read(rec):
    tel = program.telemetry(rec)
    if tel is None or not rec["jobs"] or \
            not program.spans(tel, lambda n: n in NAMES):
        return None
    return program.union_s(tel, lambda n: n in NAMES) / rec["jobs"]
