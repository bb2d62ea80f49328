"""The blind rotations' share of their roofline, in %: the least time the
card could take for the window's bootstraps (``roofline.least_seconds``
on the configuration's fixed count per item-step), over the device time of
every program kernel in the trace (the kernels that do that work, whatever
the route).  Nothing to read without a trace or a program kernel."""

from fhebench import roofline


def read(window):
    tr = window.trace
    if tr is None or not window.widths or tr.program_kernel_s() <= 0:
        return None
    least = roofline.least_seconds(window.widths, window.config,
                                   window.sm_count)
    return 100.0 * least / tr.program_kernel_s()
