"""``write_s.series``: host seconds a plotfile inside the writers' ``with
open(path, "w...")`` blocks (MEF, conditional-mean, PDF, spectrum, rms and
integral text; the session's write-back thread included), over the jobs
finished in the traced window."""
HOOKS = [{"span": "write", "open_in": [
    "peleanalysis_tpu_torch.io.mef",
    "peleanalysis_tpu_torch.tools.conditional_mean",
    "peleanalysis_tpu_torch.tools.jpdf",
    "peleanalysis_tpu_torch.tools.turbulence_spectra",
    "peleanalysis_tpu_torch.tools.rms_vel",
    "peleanalysis_tpu_torch.tools.integral"]}]


def read(rec):
    spans = rec["hooks"]["spans"].get("write")
    if not spans or not rec["jobs"]:
        return None
    return sum(t - s for s, t in spans) / rec["jobs"]
