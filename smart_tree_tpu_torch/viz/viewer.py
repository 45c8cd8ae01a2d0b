"""Interactive viewing through open3d, when it is installed (counterpart of
`smart_tree_tpu/viz/viewer.py`).

Everything the viewer would draw is built by `viewer_items`, numpy in and
out with no open3d: the cloud, the class-coloured cloud, the medial-vector
lines, the skeleton lines and the tube mesh. Without open3d `view_cloud`
and `view_skeleton` log a warning and return; saving the PLY outputs is the
headless path.
"""

from __future__ import annotations

import logging
from typing import Dict, List, NamedTuple, Optional

import numpy as np

log = logging.getLogger(__name__)

try:  # optional dependency; a broken install (missing libGL) raises OSError
    import open3d as o3d

    HAVE_O3D = True
except (ImportError, OSError):
    o3d = None
    HAVE_O3D = False

_NO_O3D = "open3d not available; skipping interactive view (use save_outputs: True for PLY export)"


class ViewerItem(NamedTuple):
    """One drawable: kind in {'cloud', 'lineset', 'mesh'}; data holds numpy
    arrays. cloud: xyz [N,3] (+ colors [N,3]); lineset: vertices [V,3] +
    edges [E,2]; mesh: vertices [V,3] + triangles [T,3] (+ colors [V,3])."""

    name: str
    kind: str
    data: Dict[str, np.ndarray]


def viewer_items(cloud=None, skeleton=None, cmap: Optional[np.ndarray] = None) -> List[ViewerItem]:
    """The geometry the interactive viewer draws for a cloud and / or a
    skeleton."""
    items: List[ViewerItem] = []
    if cloud is not None:
        xyz = np.asarray(cloud.xyz, np.float64)
        data = {"xyz": xyz}
        if cloud.rgb is not None:
            data["colors"] = np.asarray(cloud.rgb, np.float64)
        items.append(ViewerItem("cloud", "cloud", data))
        if cloud.class_l is not None and cmap is not None:
            cls = np.asarray(cloud.class_l).reshape(-1).astype(int)
            cmap = np.asarray(cmap, np.float64)
            items.append(ViewerItem("seg_cloud", "cloud",
                                    {"xyz": xyz, "colors": cmap[np.clip(cls, 0, len(cmap) - 1)]}))
        if getattr(cloud, "medial_vector", None) is not None:
            # one line per point, surface point -> its medial point
            mv = np.asarray(cloud.medial_vector, np.float64)
            n = len(xyz)
            edges = np.stack([np.arange(n), np.arange(n) + n], axis=1).astype(np.int32)
            items.append(ViewerItem("medial_vectors", "lineset",
                                    {"vertices": np.concatenate([xyz, xyz + mv]),
                                     "edges": edges}))
    if skeleton is not None:
        from .mesh import skeleton_lineset, skeleton_tube_mesh

        verts, edges = skeleton_lineset(skeleton)
        items.append(ViewerItem("skeleton", "lineset", {"vertices": verts, "edges": edges}))
        mv, mt, mc = skeleton_tube_mesh(skeleton)
        items.append(ViewerItem("tube_mesh", "mesh",
                                {"vertices": mv, "triangles": mt, "colors": mc}))
    return items


def _to_o3d(item: ViewerItem):  # needs open3d
    d = item.data
    if item.kind == "cloud":
        g = o3d.geometry.PointCloud(o3d.utility.Vector3dVector(d["xyz"]))
        if "colors" in d:
            g.colors = o3d.utility.Vector3dVector(d["colors"])
        return g
    if item.kind == "lineset":
        return o3d.geometry.LineSet(o3d.utility.Vector3dVector(d["vertices"]),
                                    o3d.utility.Vector2iVector(d["edges"]))
    g = o3d.geometry.TriangleMesh(o3d.utility.Vector3dVector(d["vertices"]),
                                  o3d.utility.Vector3iVector(d["triangles"]))
    if "colors" in d:
        g.vertex_colors = o3d.utility.Vector3dVector(d["colors"])
    g.compute_vertex_normals()
    return g


def view_cloud(cloud, cmap=None) -> None:
    if not HAVE_O3D:
        log.warning(_NO_O3D)
        return
    items = [i for i in viewer_items(cloud, cmap=cmap) if i.name != "medial_vectors"]
    o3d.visualization.draw([_to_o3d(i) for i in items])


def view_skeleton(skeleton, cloud=None) -> None:
    if not HAVE_O3D:
        log.warning(_NO_O3D)
        return
    items = viewer_items(skeleton=skeleton)
    if cloud is not None:
        items.append(ViewerItem("cloud", "cloud", {"xyz": np.asarray(cloud.xyz, np.float64)}))
    o3d.visualization.draw([_to_o3d(i) for i in items])
