"""PLY mesh reader, ascii and binary little/big endian (port of
pbrt_tpu/frontend/ply.py; the vendored rply reader as used by
shapes/plymesh.cpp): vertex positions, normals and uvs and face indices
into numpy arrays, polygons fan-triangulated.
"""

from __future__ import annotations

import numpy as np

_TYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def read_ply(path: str):
    """Returns dict with 'vertices' (V,3) f32, optional 'normals' (V,3),
    'uvs' (V,2), and 'indices' (F,3) i32 (fans triangulated)."""
    with open(path, "rb") as f:
        line = f.readline().strip()
        if line != b"ply":
            raise ValueError("not a PLY file")
        fmt = None
        elements = []  # (name, count, [(prop_type, prop_name) or list-prop])
        while True:
            line = f.readline().decode("ascii", "replace").strip()
            if line.startswith("comment") or not line:
                continue
            parts = line.split()
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                elements.append([parts[1], int(parts[2]), []])
            elif parts[0] == "property":
                if parts[1] == "list":
                    elements[-1][2].append(("list", parts[2], parts[3],
                                            parts[4]))
                else:
                    elements[-1][2].append((parts[1], parts[2]))
            elif parts[0] == "end_header":
                break

        out = {}
        endian = {"binary_little_endian": "<", "binary_big_endian": ">",
                  "ascii": None}[fmt]

        for name, count, props in elements:
            if name == "vertex":
                names = [p[1] for p in props]
                if endian:
                    dt = np.dtype([(p[1], endian + _TYPES[p[0]])
                                   for p in props])
                    data = np.frombuffer(f.read(dt.itemsize * count), dt)
                else:
                    rows = [f.readline().split() for _ in range(count)]
                    arr = np.asarray(rows, np.float64)
                    data = {n: arr[:, i] for i, n in enumerate(names)}
                get = (lambda k: np.asarray(data[k], np.float32))
                out["vertices"] = np.stack([get("x"), get("y"),
                                            get("z")], -1)
                if "nx" in names:
                    out["normals"] = np.stack([get("nx"), get("ny"),
                                               get("nz")], -1)
                if "u" in names:
                    out["uvs"] = np.stack([get("u"), get("v")], -1)
                elif "s" in names:
                    out["uvs"] = np.stack([get("s"), get("t")], -1)
            elif name == "face":
                lp = props[0]
                assert lp[0] == "list"
                cnt_t = _TYPES[lp[1]]
                idx_t = _TYPES[lp[2]]
                faces = []
                if endian:
                    cnt_dt = np.dtype(endian + cnt_t)
                    idx_dt = np.dtype(endian + idx_t)
                    for _ in range(count):
                        n = int(np.frombuffer(f.read(cnt_dt.itemsize),
                                              cnt_dt)[0])
                        idx = np.frombuffer(f.read(idx_dt.itemsize * n),
                                            idx_dt)
                        for k in range(1, n - 1):  # fan triangulation
                            faces.append((idx[0], idx[k], idx[k + 1]))
                else:
                    for _ in range(count):
                        row = list(map(int, f.readline().split()))
                        n, idx = row[0], row[1:]
                        for k in range(1, n - 1):
                            faces.append((idx[0], idx[k], idx[k + 1]))
                out["indices"] = np.asarray(faces, np.int32)
            else:
                # skip unknown element payload (binary only exact skip)
                if endian:
                    dt = np.dtype([(p[1], endian + _TYPES[p[0]])
                                   for p in props if p[0] != "list"])
                    f.read(dt.itemsize * count)
                else:
                    for _ in range(count):
                        f.readline()
        return out
