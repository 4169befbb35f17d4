"""Wide-BVH scene queries (port of take_tpu/geometry/traverse.py).

Triangles go through one of three routes, each a CUDA kernel for rays on
the card and the kernel's plain twin for rays on the CPU:
  * the packet route (default): K3, per-ray stack traversal of the wide BVH
    (geometry/packet.py);
  * the cluster route (FORCE_CLUSTER): K4/K5, the streaming supercluster
    sweep (geometry/cluster.py);
  * the sweep route (FORCE_SWEEP, which wins over FORCE_CLUSTER): K6, the
    tree-free cluster cull and sweep (geometry/sweep.py), for closest-hit
    queries only; any-hit queries keep K3 (or K4/K5), as in the JAX
    package, whose FORCE_SWEEP switch routes only closest hits.
The JAX package picks the cluster route when the BVH tables outgrow the
TPU's VMEM (`_packet_eligible`); K3 reads its tables from global memory at
any size, so the port has no such gate. Spheres are tested densely and
merged after, as in the brute path.

The JAX package sorts each query's rays for coherence before its kernels
(`_coherence_perm`); the port does not. On the H100 the sort's key, argsort
and row gathers cost more launches and device time than they save in K3,
and a room render is faster without it.
"""

import torch

from take_tpu_torch import tracing
from take_tpu_torch.core.math import gather_rows
from take_tpu_torch.geometry import cluster, packet, sweep
from take_tpu_torch.scene.types import ATTR_EMIT, Hit, Scene

FORCE_CLUSTER = False  # route BVH queries to K4/K5 instead of K3
FORCE_SWEEP = False  # route closest-hit BVH queries to K6 (wins over FORCE_CLUSTER)

_BIG = packet.BIG


def _traverse_backend(scene: Scene, ro, rd, tmin, tmax):
    """(t, u, v, prim, found) of the closest triangle hits.

    The rays come in detached and the kernels read derived tables: the
    traversal is constant under AD, as take_tpu's (its while loop and
    Pallas kernels are primal-only), and emission stays differentiable
    through the attribute gather in bvh_intersect."""
    bvh = scene.bvh
    ro, rd, tmin, tmax = ro.detach(), rd.detach(), tmin.detach(), tmax.detach()
    if FORCE_SWEEP:
        t, u, v, prim = sweep.closest(bvh.cl_aabb, bvh.tris, scene.meta.n_tri, ro, rd, tmin, tmax)
    elif FORCE_CLUSTER:
        t, u, v, prim = cluster.closest(bvh.sup_aabb, bvh.cl_aabb, bvh.tris, ro, rd, tmin, tmax)
    else:
        t, u, v, prim = packet.closest(bvh, ro, rd, tmin, tmax)
    return t, u, v, prim, prim >= 0


def bvh_intersect(scene: Scene, ro, rd, tmin, tmax) -> Hit:
    """Closest-hit query of a BVH scene; the Hit is assembled from the
    winners' attribute rows, as on the brute path (tracing phase hit)."""
    from take_tpu_torch.geometry.intersect import _merge_and_shade

    t, u, v, prim, found = _traverse_backend(scene, ro, rd, tmin, tmax)
    tracing.mark("hit")
    # the brute path's gradient scope: geometry columns detached, the EMIT
    # slice differentiable (the gather's backward adds into it)
    A, idx = scene.geometry.tri_attr, prim.clamp(min=0).long()
    rows = A.detach()[idx]
    emit = gather_rows(A[:, ATTR_EMIT : ATTR_EMIT + 3], idx)
    attrs = torch.cat([rows[:, :ATTR_EMIT], emit, rows[:, ATTR_EMIT + 3 :]], dim=1)
    tri_t = torch.where(found, t, _BIG)
    return _merge_and_shade(scene, ro, rd, tmin, tmax, tri_t, found, attrs, u, v)


def bvh_occluded(scene: Scene, ro, rd, tmin, tmax):
    """Any-hit query of a BVH scene: True where something lies in [tmin, tmax]."""
    from take_tpu_torch.geometry.intersect import _sph_t

    bvh, g = scene.bvh, scene.geometry
    ro, rd, tmin, tmax = ro.detach(), rd.detach(), tmin.detach(), tmax.detach()
    if FORCE_CLUSTER:
        found = cluster.occluded(bvh.sup_aabb, bvh.cl_aabb, bvh.tris, ro, rd, tmin, tmax)
    else:
        found = packet.occluded(bvh, ro, rd, tmin, tmax)
    if scene.meta.n_sph > 0:
        found = found | _sph_t(g, ro, rd, tmin, tmax, scene.meta.n_sph)[1].any(dim=1)
    return found
