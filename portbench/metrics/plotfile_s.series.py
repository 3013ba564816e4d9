"""``plotfile_s.series``: the traced window's seconds over the jobs
finished in it, each a whole ``pipeline`` with every output on disk: a
time a plotfile over all the window's work, read with the profiler and
the hooks on."""
HOOKS = []


def read(rec):
    if not rec["jobs"]:
        return None
    return rec["window_s"] / rec["jobs"]
