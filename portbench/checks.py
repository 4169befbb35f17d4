"""The numbers that decide `correct`, and their limits.

Images: each image the window produced, at a sample of pixels drawn from
the seed, against the reference's render of the same pixels with the same
paths. A pixel is off when a channel differs from the reference's by more
than PIXEL_TOL of the reference's value, plus a floor of FLOOR_SHARE of
the sample's mean so that near-black pixels do not decide, or when it is
not finite. Two numbers: `pixels_off`, the share of the sample that is off
in the worst image, and `mean_gap`, the worst relative gap of a channel's
mean over the sample's finite pixels.

Gradients (an optimisation loop, whose set-up steps the reference
follows): `loss_gap`, the worst relative gap of a set-up step's loss;
`grad_gap`, the gap between the program's and the reference's first
gradient norms of the worst leaf, over the larger of the reference's norm
of that leaf and of the median leaf; `change_gap`, the same for the
parameters' change over the set-up steps, leaving out leaves whose
reference gradient is under GRAD_FLOOR of the median leaf's;
`step_grad_gap`, the same as `grad_gap` for the gradient of one window
step drawn from the seed, which the reference takes at the program's
parameters of that step.
"""

import statistics

import numpy as np

PIXEL_TOL = 1e-3
FLOOR_SHARE = 1e-2
GRAD_FLOOR = 1e-3


def image_numbers(got, ref):
    """got [n_images, P, 3] and ref [P, 3] (numpy) -> {pixels_off, mean_gap}.
    A pixel that is not finite is off; the channel means are taken over
    each image's finite pixels and the reference's same pixels."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    scale = np.abs(ref) + FLOOR_SHARE * np.abs(ref).mean()
    finite = np.isfinite(got).all(axis=-1)  # [n_images, P]
    with np.errstate(invalid="ignore"):
        off = (np.abs(got - ref[None]) > PIXEL_TOL * scale[None]).any(axis=-1) | ~finite
    w = finite[..., None].astype(np.float64)
    n = np.maximum(w.sum(axis=1), 1.0)
    means = np.where(w > 0, got, 0.0).sum(axis=1) / n
    want = (w * ref[None]).sum(axis=1) / n
    gap = np.abs(means - want) / np.maximum(np.abs(want), 1e-30)
    gap = np.where(finite.any(axis=1)[:, None], gap, np.inf)
    return {"pixels_off": float(off.mean(axis=-1).max()), "mean_gap": float(gap.max())}


def leaf_gap(got: dict, ref: dict, leaves=None):
    """Worst |norm(got[k]) - norm(ref[k])| / max(norm(ref[k]), median leaf norm of ref)."""
    leaves = list(ref) if leaves is None else leaves
    norms = {k: float(np.linalg.norm(ref[k])) for k in ref}
    med = statistics.median(norms.values())
    gaps = [abs(float(np.linalg.norm(got[k])) - norms[k]) / max(norms[k], med, 1e-30) for k in leaves]
    return max(gaps) if all(np.isfinite(gaps)) else float("inf")


def moved_leaves(ref_grad: dict):
    """The leaves whose reference gradient is at least GRAD_FLOOR of the median leaf's."""
    norms = {k: float(np.linalg.norm(v)) for k, v in ref_grad.items()}
    med = statistics.median(norms.values())
    return [k for k, n in norms.items() if n >= GRAD_FLOOR * med]


def judge(numbers: dict, limits: dict):
    """(correct, [(name, value, limit)]): correct when every number is finite
    and at most its limit."""
    rows = [(k, float(numbers[k]), float(limits[k])) for k in limits]
    return all(np.isfinite(v) and v <= lim for _, v, lim in rows), rows
