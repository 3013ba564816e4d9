"""``read_s.series``: host seconds a plotfile inside the program's plotfile
reads (``session.load_plotfile_fabs``, whichever thread reads), over the
jobs finished in the traced window."""
HOOKS = [{"span": "read",
          "target": "peleanalysis_tpu_torch.session:load_plotfile_fabs"}]


def read(rec):
    spans = rec["hooks"]["spans"].get("read")
    if not spans or not rec["jobs"]:
        return None
    return sum(t - s for s, t in spans) / rec["jobs"]
