"""glue_ms.mesh: the wavefront glue's host time per mesh frame, in ms:
per traced frame, the length of its `render` span minus the time its
`sort` spans (the rays' sorts) and `launch.*` spans (the kernel
wrappers) cover; the mean over the frames (program spans)."""

from perfbench import spans


def read(run):
    return spans.glue_ms(run)
