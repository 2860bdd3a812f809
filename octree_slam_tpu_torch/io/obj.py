"""Wavefront OBJ reader and writer (counterpart: octree_slam_tpu/io/obj.py).

The reader replaces the vendored objUtil parser (objloader.cpp:14-129,
obj::buildVBOs obj.cpp:33-135): v / vt / vn lines, faces with any of the
v, v/vt, v//vn, v/vt/vn index forms (negative indices too), fan
triangulation of polygons, the 'v x y z r g b' colour extension, smooth
vertex normals when the file has none. `load_obj` takes the reference's
route: the native C++ parser (io/native.py load_obj_arrays) when the
runtime is built and the file has no vertex colours, else the Python
parser, whose line parse is the reference's and whose per-corner gathers
and normal sums run vectorised in the same order. Either way the arrays
equal the reference's load_obj bit for bit on the same host; the two
parsers' smooth normals differ within 1e-6, as the reference's do.
"""

from __future__ import annotations

import numpy as np
import torch

from octree_slam_tpu_torch.core.types import BoundingBox, Mesh


def _parse_index(tok: str, count: int) -> int:
    i = int(tok)
    return i - 1 if i > 0 else count + i


def _has_vertex_colors(path: str) -> bool:
    """Sniff the first 'v ' line for the 7-field vertex-colour extension
    (a file whose first face comes first has none)."""
    try:
        with open(path, "r") as f:
            for line in f:
                s = line.strip()
                if s.startswith("v "):
                    return len(s.split()) >= 7
                if s.startswith("f "):
                    return False
    except OSError:
        pass
    return False


def _mesh(v, n, colors, f, uv, lo, hi, device) -> Mesh:
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return Mesh(vertices=t(v), normals=t(n), colors=t(colors), faces=t(f),
                texcoords=t(uv), bbox=BoundingBox(t(lo), t(hi)))


def load_obj(path: str, device="cuda") -> Mesh:
    """Parse `path` into a Mesh on `device`: the native parser where the
    runtime is built and the file has no vertex colours (it reads 'v x y
    z' only, so a colour-extended file, save_obj's, takes the Python path
    and keeps its colours), else the Python parser; the reference's rule
    (octree_slam_tpu/io/obj.py load_obj)."""
    try:
        from octree_slam_tpu_torch.io import native
        if native.available() and not _has_vertex_colors(path):
            v, n, f, uv, lo, hi = native.load_obj_arrays(path)
            return _mesh(v, n, np.ones_like(v), f, uv, lo, hi, device)
    except (ImportError, OSError):
        pass
    return _load_obj_py(path, device)


def _load_obj_py(path: str, device) -> Mesh:
    positions = []
    vcolors = []
    texcoords = []
    normals = []
    corners_of = []   # per triangle: ((vi, ti, ni),) * 3
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            tag = parts[0]
            if tag == "v":
                positions.append([float(x) for x in parts[1:4]])
                vcolors.append([float(x) for x in parts[4:7]]
                               if len(parts) >= 7 else None)
            elif tag == "vt":
                u = float(parts[1])
                v = float(parts[2]) if len(parts) > 2 else 0.0
                texcoords.append([u, v])
            elif tag == "vn":
                normals.append([float(x) for x in parts[1:4]])
            elif tag == "f":
                corners = []
                for tok in parts[1:]:
                    comps = tok.split("/")
                    vi = _parse_index(comps[0], len(positions))
                    ti = (_parse_index(comps[1], len(texcoords))
                          if len(comps) > 1 and comps[1] else -1)
                    ni = (_parse_index(comps[2], len(normals))
                          if len(comps) > 2 and comps[2] else -1)
                    corners.append((vi, ti, ni))
                for k in range(1, len(corners) - 1):  # fan triangulation
                    corners_of.append((corners[0], corners[k],
                                       corners[k + 1]))

    v = np.asarray(positions, np.float32).reshape(-1, 3)
    vt = np.asarray(texcoords, np.float32).reshape(-1, 2)
    vn = np.asarray(normals, np.float32).reshape(-1, 3)
    idx = np.asarray(corners_of, np.int64).reshape(-1, 3, 3)
    fidx = idx[..., 0].astype(np.int32)
    tidx = idx[..., 1]
    nidx = idx[..., 2]

    # per-corner texcoords [F, 3, 2]
    fuv = np.zeros((fidx.shape[0], 3, 2), np.float32)
    has_t = (tidx >= 0) & (tidx < vt.shape[0])
    fuv[has_t] = vt[tidx[has_t]]

    # smooth vertex normals: the file's normals averaged per vertex, else
    # area-weighted face normals (np.add.at sums in corner order, as the
    # reference's loops do)
    vnorm = np.zeros_like(v)
    if vn.shape[0]:
        counts = np.zeros((v.shape[0], 1), np.float32)
        has_n = nidx >= 0
        np.add.at(vnorm, fidx[has_n], vn[nidx[has_n]])
        np.add.at(counts, fidx[has_n], np.float32(1.0))
        vnorm = np.where(counts > 0, vnorm / np.maximum(counts, 1), vnorm)
    if not vn.shape[0] or not np.any(np.abs(vnorm) > 0):
        a, b, c = v[fidx[:, 0]], v[fidx[:, 1]], v[fidx[:, 2]]
        n = np.cross(b - a, c - a)
        np.add.at(vnorm, fidx.reshape(-1), np.repeat(n, 3, axis=0))
    lens = np.linalg.norm(vnorm, axis=1, keepdims=True)
    vnorm = vnorm / np.maximum(lens, 1e-12)

    lo = v.min(0) if v.size else np.zeros(3, np.float32)
    hi = v.max(0) if v.size else np.zeros(3, np.float32)
    colors = (np.asarray([c if c is not None else [1.0, 1.0, 1.0]
                          for c in vcolors], np.float32)
              if vcolors else np.ones_like(v))
    return _mesh(v, vnorm.astype(np.float32), colors, fidx, fuv, lo, hi,
                 device)


def save_obj(path: str, mesh: Mesh) -> None:
    """Write a Mesh as Wavefront OBJ: vertex colours as the 'v x y z r g b'
    extension (read back by load_obj, MeshLab and Blender), per-vertex
    'vn' lines referenced by the faces. The reference displays voxel-cube
    meshes (voxelGridToMesh, voxelization.cu:325-379) but never exports
    them."""
    v = mesh.vertices.detach().cpu().numpy().astype(np.float64)
    n = mesh.normals.detach().cpu().numpy().astype(np.float64)
    c = mesh.colors.detach().cpu().numpy().astype(np.float64)
    f1 = mesh.faces.detach().cpu().numpy().astype(np.int64) + 1  # 1-based
    has_n = n.size == v.size
    has_c = c.size == v.size

    # chunked row formatting: a voxel-cube export reaches millions of
    # lines; tolist() turns a chunk into Python floats in C, and
    # '%'-formatting a row is then ~1-2 us
    def rows(out, fmt, arr, chunk=1 << 18):
        for i in range(0, arr.shape[0], chunk):
            block = arr[i:i + chunk].tolist()
            out.write("\n".join(fmt % tuple(r) for r in block))
            out.write("\n")

    with open(path, "w") as out:
        out.write("# octree-slam-tpu mesh export: %d verts, %d tris\n"
                  % (v.shape[0], f1.shape[0]))
        if has_c:
            rows(out, "v %.6f %.6f %.6f %.4f %.4f %.4f",
                 np.concatenate([v, c], axis=1))
        else:
            rows(out, "v %.6f %.6f %.6f", v)
        if has_n:
            rows(out, "vn %.6f %.6f %.6f", n)
            rows(out, "f %d//%d %d//%d %d//%d", f1[:, [0, 0, 1, 1, 2, 2]])
        else:
            rows(out, "f %d %d %d", f1)
