"""The arithmetic the metrics are counted by, kept with the benchmark so that
no change to the program moves it.

Rays of a path: the camera query, then per trip of the fixed-trip loop
(max_depth + 1 trips) one shadow and one bounce query (bench.py's count).
The H100's peak bandwidth and the bytes of a scene query come from the
data sheet and the queries' operands: a ray is read once (origin,
direction, tmin, tmax: 32 bytes), each answer is written once, and the
triangle rows are read once a call. The least time of a call is its bytes
over the peak bandwidth.
"""

HBM_BYTES_S = 3.35e12  # NVIDIA H100 SXM 80GB, data sheet
RAY_BYTES = 32
TRI_ROW_BYTES = 96  # 24 float32 per triangle row


def rays_per_path(max_depth: int) -> int:
    return 1 + 2 * (max_depth + 1)


def rays_per_image(width: int, height: int, spp: int, max_depth: int) -> int:
    return width * height * spp * rays_per_path(max_depth)


def query_bytes(rays: int, calls: int, answer_bytes: int, n_tri: int) -> int:
    """Bytes a set of calls of one scene query needs at least: `rays` rays
    over all calls, each read once and answered once, and the triangle rows
    read once a call."""
    return rays * (RAY_BYTES + answer_bytes) + calls * n_tri * TRI_ROW_BYTES


def least_seconds(nbytes: float) -> float:
    return nbytes / HBM_BYTES_S
