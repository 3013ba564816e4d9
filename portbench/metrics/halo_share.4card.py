"""``halo_share.4card``: percent more cells the shard windows hold than
their shards own, in the traced window: ``100 * (shard.window_cells -
shard.owned_cells) / shard.owned_cells``, the windows' every level, halo
included, against the cells (the isosurface: the dual cells) the shards
answer for.  None where the program has no such counter."""
from portbench import program

HOOKS = program.HOOKS


def read(rec):
    tel = program.telemetry(rec)
    c = tel["counters"] if tel else {}
    own = c.get("shard.owned_cells", 0)
    if not own:
        return None
    return 100.0 * (c.get("shard.window_cells", 0) - own) / own
