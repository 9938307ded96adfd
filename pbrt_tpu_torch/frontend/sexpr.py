"""S-expressions of the fork's portalData syntax (port of
pbrt_tpu/frontend/sexpr.py; the vendored sexpresso parser as read by
CreateAAPortal, lights/portal_arealight.cpp:256-292):
``"((AA lox loy loz hix hiy hiz axis ±) ...)"``."""

from __future__ import annotations


def parse_sexpr(s: str):
    """Parse into nested lists of strings."""
    tokens = s.replace("(", " ( ").replace(")", " ) ").split()
    pos = 0

    def parse():
        nonlocal pos
        out = []
        while pos < len(tokens):
            t = tokens[pos]
            pos += 1
            if t == "(":
                out.append(parse())
            elif t == ")":
                return out
            else:
                out.append(t)
        return out

    return parse()


def parse_portal_data(s: str):
    """portalData string → list of (lo, hi, axis, facing_fw) tuples
    (lights/portal_arealight.cpp:257-283)."""
    tree = parse_sexpr(s)
    # the outermost parse yields [ [ [AA ...], [AA ...] ] ]
    root = tree[0] if tree and isinstance(tree[0], list) else tree
    portals = []
    for node in root:
        if not isinstance(node, list) or not node or node[0] != "AA":
            continue
        vals = [float(x) for x in node[1:7]]
        portals.append(((vals[0], vals[1], vals[2]),
                        (vals[3], vals[4], vals[5]), int(node[7]),
                        node[8] == "+"))
    return portals
