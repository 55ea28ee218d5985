"""cell_scan_roofline: the int8 cell scan's least time (``roofline.py``:
the probed cells' codes, scales and table rows read once a batch, the
queries read, the scores written, products at 2xTF32) summed over the
window's batches, over the scan kernel's device time in the trace, in %.
"""
from portbench import roofline

#: the cell scan kernel's name in the trace (``csrc/qdist.cu``)
KERNEL = "qdist_cells"


def read(run):
    if run.trace is None or not run.batches:
        return None
    device_s = sum(s for name, s in run.trace.by_kernel.items()
                   if KERNEL in name)
    if device_s <= 0:
        return None
    return 100.0 * roofline.window_least_s(run)["scan_s"] / device_s
