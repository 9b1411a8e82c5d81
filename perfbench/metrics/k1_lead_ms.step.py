"""k1_lead_ms.step: how long a training step's K1 (with records) waits
for the step's host side, in ms: per traced step, the device start of the
first pathtrace_kernel<true launch after the step's `train.step` span
opens, minus the span's start; the mean over the steps (program spans on
the profiler's clock, and the profiler trace)."""

from perfbench import spans


def read(run):
    return spans.lead_ms(run, "train.step", "pathtrace_kernel<true")
