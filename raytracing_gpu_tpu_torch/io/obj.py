"""Wavefront OBJ/MTL loader (the port's copy of
`raytracing_gpu_tpu/io/obj.py`, numpy only).

Replaces the reference's Assimp pipeline (`triangle_mesh.h:51-143`:
`load_model` -> `processNode` -> `processMesh` with aiProcess_Triangulate |
aiProcess_GenSmoothNormals, extracting positions/normals/uvs/indices and the
diffuse texture path per mesh).  This covers the same feature subset natively:
v/vt/vn records, f faces with v, v/vt, v//vn, v/vt/vn indexing (negative
indices allowed), polygon fan triangulation, usemtl submesh grouping, and
map_Kd / Kd lookup from the companion .mtl.  Missing normals are generated as
area-weighted smooth vertex normals (the Assimp GenSmoothNormals equivalent).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class SubMesh:
    """One usemtl group, indexed into its own compact vertex arrays."""

    vertices: np.ndarray           # (V, 3) float32
    faces: np.ndarray              # (F, 3) int64
    uvs: np.ndarray                # (V, 2) float32
    normals: np.ndarray            # (V, 3) float32
    material: str = ""
    diffuse_texture: Optional[str] = None  # absolute path if found
    diffuse_color: tuple = (0.8, 0.8, 0.8)


@dataclass
class ObjModel:
    submeshes: list = field(default_factory=list)

    @property
    def num_triangles(self) -> int:
        return sum(len(s.faces) for s in self.submeshes)


def load_obj(path: str, generate_normals: bool = True) -> ObjModel:
    positions: list = []
    texcoords: list = []
    normals: list = []
    # one corner-index list per material group
    groups: dict[str, list] = {}
    current = "__default__"
    mtl_info: dict[str, dict] = {}
    base = os.path.dirname(os.path.abspath(path))

    with open(path, errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                positions.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("vt "):
                t = line.split()[1:3]
                texcoords.append([float(t[0]), float(t[1]) if len(t) > 1 else 0.0])
            elif line.startswith("vn "):
                normals.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("usemtl"):
                parts = line.split(maxsplit=1)
                current = parts[1].strip() if len(parts) > 1 else "__default__"
            elif line.startswith("mtllib"):
                parts = line.split(maxsplit=1)
                if len(parts) > 1:
                    mtl_path = os.path.join(base, parts[1].strip())
                    if os.path.exists(mtl_path):
                        mtl_info.update(_load_mtl(mtl_path))
            elif line.startswith("f "):
                corners = [_parse_corner(tok) for tok in line.split()[1:]]
                bucket = groups.setdefault(current, [])
                # polygon fan triangulation (Assimp aiProcess_Triangulate)
                for i in range(1, len(corners) - 1):
                    bucket.append((corners[0], corners[i], corners[i + 1]))

    pos = np.asarray(positions, np.float32).reshape(-1, 3)
    uv = np.asarray(texcoords, np.float32).reshape(-1, 2) if texcoords else None
    nrm = np.asarray(normals, np.float32).reshape(-1, 3) if normals else None

    model = ObjModel()
    for mat_name, tris in groups.items():
        if not tris:
            continue
        sub = _build_submesh(pos, uv, nrm, tris, generate_normals)
        sub.material = mat_name
        info = mtl_info.get(mat_name, {})
        if "map_Kd" in info:
            tex = os.path.join(base, info["map_Kd"])
            if os.path.exists(tex):
                sub.diffuse_texture = tex
        if "Kd" in info:
            sub.diffuse_color = tuple(info["Kd"])
        model.submeshes.append(sub)
    return model


def _parse_corner(tok: str):
    """'v', 'v/vt', 'v//vn', 'v/vt/vn' -> (vi, ti, ni) zero-based or None."""
    parts = tok.split("/")
    vi = int(parts[0])
    ti = int(parts[1]) if len(parts) > 1 and parts[1] else None
    ni = int(parts[2]) if len(parts) > 2 and parts[2] else None
    return vi, ti, ni


def _resolve(idx: Optional[int], count: int) -> Optional[int]:
    if idx is None:
        return None
    return idx - 1 if idx > 0 else count + idx


def _build_submesh(pos, uv, nrm, tris, generate_normals) -> SubMesh:
    """Compact (position, uv, normal) corner triples into unique vertices —
    the flattened-arrays layout of `create_meshes` (`triangle_mesh.h:253-282`)."""
    remap: dict = {}
    verts: list = []
    uvs: list = []
    nrms: list = []
    faces = np.zeros((len(tris), 3), np.int64)
    for fi, tri in enumerate(tris):
        for ci, (vi, ti, ni) in enumerate(tri):
            key = (vi, ti, ni)
            if key not in remap:
                remap[key] = len(verts)
                v = _resolve(vi, len(pos))
                verts.append(pos[v])
                t = _resolve(ti, len(uv) if uv is not None else 0)
                uvs.append(uv[t] if (uv is not None and t is not None) else (0.0, 0.0))
                n = _resolve(ni, len(nrm) if nrm is not None else 0)
                nrms.append(
                    nrm[n] if (nrm is not None and n is not None) else (0.0, 0.0, 0.0)
                )
            faces[fi, ci] = remap[key]

    vertices = np.asarray(verts, np.float32).reshape(-1, 3)
    uv_arr = np.asarray(uvs, np.float32).reshape(-1, 2)
    n_arr = np.asarray(nrms, np.float32).reshape(-1, 3)

    if generate_normals and (n_arr == 0).all(axis=1).any():
        n_arr = _smooth_normals(vertices, faces, n_arr)

    return SubMesh(vertices=vertices, faces=faces, uvs=uv_arr, normals=n_arr)


def _smooth_normals(vertices, faces, existing) -> np.ndarray:
    """Area-weighted vertex normals where none were supplied (the Assimp
    aiProcess_GenSmoothNormals equivalent, `triangle_mesh.h:133`)."""
    out = existing.copy()
    fn = np.cross(
        vertices[faces[:, 1]] - vertices[faces[:, 0]],
        vertices[faces[:, 2]] - vertices[faces[:, 0]],
    )
    acc = np.zeros_like(vertices)
    for c in range(3):
        np.add.at(acc, faces[:, c], fn)
    missing = (out == 0).all(axis=1)
    norms = np.linalg.norm(acc, axis=1, keepdims=True)
    acc = acc / np.maximum(norms, 1e-12)
    out[missing] = acc[missing]
    return out


def _load_mtl(path: str) -> dict:
    """Minimal MTL parse: newmtl + Kd + map_Kd (the only fields the reference
    consumes via aiTextureType_DIFFUSE, `triangle_mesh.h:96-116`)."""
    mats: dict[str, dict] = {}
    current = None
    with open(path, errors="replace") as f:
        for line in f:
            s = line.strip()
            if s.startswith("newmtl"):
                current = s.split(maxsplit=1)[1] if " " in s else ""
                mats[current] = {}
            elif current is not None and s.startswith("map_Kd"):
                # strip options like -bm 0.1
                toks = s.split()
                mats[current]["map_Kd"] = toks[-1]
            elif current is not None and s.startswith("Kd "):
                mats[current]["Kd"] = [float(x) for x in s.split()[1:4]]
    return mats
