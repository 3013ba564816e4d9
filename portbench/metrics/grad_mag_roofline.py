"""``grad_mag_roofline``: the least time the card could take for every
``grad_mag`` launch of the traced window (``portbench.roofline.grad_mag``:
the grown field read once, the gradient written once), summed, as a
percent of the ``grad_mag_kernel`` device time."""
from portbench import roofline

HOOKS = [{"calls": "grad_mag",
          "target": "peleanalysis_tpu_torch.ops.grad_kernels:grad_mag"}]


def read(rec):
    tr = rec.get("trace")
    if not tr:
        return None
    calls = rec["hooks"]["calls"].get("grad_mag", [])
    return roofline.share(roofline.least_s(calls, roofline.grad_mag),
                          roofline.kernel_seconds(tr, ["grad_mag_kernel"]))
