"""bounce_shade_ms: device time a wave of the wavefront bounce's ``shade``
stage (the shading-row gather, the materials and the emissive hit's
MIS): the program's ``shade`` spans at every depth, over the traced
waves."""
from pgbench.metrics._program import device_ms_per


def read(run):
    return device_ms_per("shade", "wave")
