"""launches_per_clip.sync: device kernels a hand-in launches (copies and
fills of the copy engines not counted), the mean over the marked clips of
the trace. Layer: ops (every CUDA kernel a clip launches)."""

from benchmark.trace import is_kernel


def read(ctx):
    clips = ctx.trace.clips
    if not clips:
        return None
    return sum(sum(1 for e in c if is_kernel(e[0])) for c in clips) / len(clips)
