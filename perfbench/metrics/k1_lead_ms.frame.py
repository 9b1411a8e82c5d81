"""k1_lead_ms.frame: how long a frame's K1 waits for its host side, in
ms: per traced frame, the device start of the first forward K1 launch
(pathtrace_kernel<false) after the frame's `render` span opens, minus the
span's start; the mean over the frames (program spans on the profiler's
clock, and the profiler trace)."""

from perfbench import spans


def read(run):
    return spans.lead_ms(run, "render", "pathtrace_kernel<false")
