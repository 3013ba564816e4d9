"""``stats_hist_roofline``: the least time the card could take for every
``binned_moments`` and ``joint_hist`` call of the traced window (values,
mask and weights read once, the bins written once), summed, as a percent
of the device time of the stats kernels (``binned_*`` and ``joint_*``)."""
from portbench import roofline

HOOKS = [{"calls": "binned_moments",
          "target": "peleanalysis_tpu_torch.ops.stats_kernels:binned_moments"},
         {"calls": "joint_hist",
          "target": "peleanalysis_tpu_torch.ops.stats_kernels:joint_hist"}]
KERNELS = ["binned_kernel", "binned_device", "binned_finish",
           "joint_kernel", "joint_device", "joint_finish"]


def read(rec):
    tr = rec.get("trace")
    if not tr:
        return None
    calls = rec["hooks"]["calls"]
    least = (roofline.least_s(calls.get("binned_moments", []),
                              roofline.binned_moments)
             + roofline.least_s(calls.get("joint_hist", []),
                                roofline.joint_hist))
    return roofline.share(least, roofline.kernel_seconds(tr, KERNELS))
