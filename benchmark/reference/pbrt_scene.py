"""A small reader of the pbrt-v3 scene format, for the benchmark's plain
references only.

It reads the statements the benchmark's frozen scenes use (Film,
PixelFilter, Sampler, Integrator, LookAt, Camera, WorldBegin/End,
AttributeBegin/End, Material, AreaLightSource, Shape) into plain Python
values, and raises on any other statement, so a scene that needs more is
noticed at once. It shares no code with the renderer under test.
"""

from __future__ import annotations

import re

_TOKEN = re.compile(r'"[^"]*"|\[|\]|[^\s\[\]"]+')


def tokenize(text: str) -> list[str]:
    lines = [ln.split("#", 1)[0] for ln in text.splitlines()]
    return _TOKEN.findall("\n".join(lines))


def _value(tok: str):
    if tok.startswith('"'):
        return tok[1:-1]
    return float(tok)


def _params(toks, i):
    """Parameters ``"type name" value`` or ``"type name" [values]`` from
    token ``i`` on; returns ({name: (type, [values])}, next index)."""
    out = {}
    while i < len(toks) and toks[i].startswith('"'):
        decl = toks[i][1:-1].split()
        if len(decl) != 2:
            break
        i += 1
        if toks[i] == "[":
            j = toks.index("]", i)
            vals = [_value(t) for t in toks[i + 1:j]]
            i = j + 1
        else:
            vals = [_value(toks[i])]
            i += 1
        out[decl[1]] = (decl[0], vals)
    return out, i


def parse(text: str) -> dict:
    """The statements of a scene file as a dict: ``film``, ``filter``,
    ``sampler``, ``integrator``, ``camera`` (each (name, params)),
    ``look_at`` (9 floats), and ``shapes``: a list of dicts with the
    shape's name and params, its material (row, name, params) and its
    area light (name, params) or None. Material rows are numbered as pbrt
    creates materials: 0 the default matte, then one a Material
    statement, in the file's order."""
    toks = tokenize(text)
    scene = {"shapes": [], "look_at": None, "n_materials": 1}
    material = (0, "matte", {})
    area = None
    stack = []
    i = 0
    while i < len(toks):
        t = toks[i]
        i += 1
        if t in ("WorldBegin", "WorldEnd"):
            continue
        if t == "AttributeBegin":
            stack.append((material, area))
            continue
        if t == "AttributeEnd":
            material, area = stack.pop()
            continue
        if t == "LookAt":
            scene["look_at"] = [float(x) for x in toks[i:i + 9]]
            i += 9
            continue
        if t in ("Film", "PixelFilter", "Sampler", "Integrator", "Camera",
                 "Material", "AreaLightSource", "Shape"):
            name = toks[i][1:-1]
            params, i = _params(toks, i + 1)
            if t == "Material":
                material = (scene["n_materials"], name, params)
                scene["n_materials"] += 1
            elif t == "AreaLightSource":
                area = (name, params)
            elif t == "Shape":
                scene["shapes"].append({"name": name, "params": params,
                                        "material": material,
                                        "area": area})
            else:
                scene[t.lower()] = (name, params)
            continue
        raise ValueError(f"statement {t!r} is not read by the reference")
    return scene


def one(params: dict, name: str, default=None):
    if name not in params:
        return default
    return params[name][1][0]


def many(params: dict, name: str, default=None):
    if name not in params:
        return default
    return params[name][1]
