"""The dense traversal kernels' share of their memory roofline per frame.

Work, counted by the benchmark's reference on the frames it checks (never
by the port): the live queries, extension rays alive at their bounce and
shadow rays with a positive range, per pixel, times the frame's pixels.
Each query reads one ray record (origin, direction, range: 7 float32) and
writes one hit record (closest: t and prim, 8 bytes; occlusion: 1 byte).
The scene's triangles (3 float32 vertices each) are read once per query
round: chunks x bounces x {closest, any}. The least time is those bytes
over 3.35 TB/s (H100 SXM); the share is that over the traversal kernels'
device time. No operation count: a traversal's operations are set by its
acceleration structure.
"""

from pbrt_bench.harness import PEAK_HBM_BYTES_PER_S, load_module

RAY_BYTES = 28
CLOSEST_OUT_BYTES = 8
ANY_OUT_BYTES = 1
TRIANGLE_BYTES = 36


def frame_bytes(render: dict, counted: dict) -> float:
    n = render["width"] * render["height"]
    chunks = -(-n // render["chunk_pixels"])
    rounds = chunks * render["bounces"] * 2
    return (n * counted["closest_per_pixel"] * (RAY_BYTES + CLOSEST_OUT_BYTES)
            + n * counted["any_per_pixel"] * (RAY_BYTES + ANY_OUT_BYTES)
            + rounds * counted["triangles"] * TRIANGLE_BYTES)


def read(run):
    if run.trace is None or not run.counted:
        return None
    traversal_ms = load_module("metrics", "traversal_device_ms.frame").read(run)
    if not traversal_ms:
        return None
    least_s = frame_bytes(run.cfg["render"], run.counted) / PEAK_HBM_BYTES_PER_S
    return 100.0 * least_s / (traversal_ms / 1e3)
