"""Read and write manual image annotations stored as SVG.

The counterpart of :mod:`glimpse_tpu.svg`, standard library only: extract
vertex coordinates of ``path``/``polyline``/``polygon``/``line``/``circle``/
``rect`` elements (grouped by ``svg``/``g``, keyed by an attribute such as
``id``), apply ``translate``/``scale``/``matrix`` transforms, and rescale
results to image coordinates using the embedded ``image`` element. Also
provides element constructors and a writer for producing annotation SVGs.
"""
import copy
import re
import warnings
import xml.etree.ElementTree as ET
from collections import defaultdict
from pathlib import Path as FilePath
from typing import Any, Dict, Iterable, List, Optional, TextIO, Tuple, Union

Number = Union[int, float]
Coordinates = List[Tuple[Number, Number]]

_NUMBER_RE = re.compile(
    r"(?:\+|\-)?(?:\.[0-9]+|[0-9]+(?:\.[0-9]+)?)(?:[Ee][+-]?[0-9]+)?"
)
_NS_RE = re.compile(r"\{.*\}")


def _num(x: Union[str, Number]) -> Number:
    """Parse a numeric string as int if possible, else float."""
    if isinstance(x, str):
        try:
            return int(x)
        except ValueError:
            return float(x)
    return x


def _numbers(s: str) -> List[Number]:
    return [_num(m) for m in _NUMBER_RE.findall(s)]


def _pairs(seq: Iterable) -> Iterable[Tuple]:
    it = iter(seq)
    return zip(it, it)


def _strip_namespaces(tree: ET.ElementTree) -> None:
    for e in tree.iter():
        e.tag = _NS_RE.sub("", e.tag)
        e.attrib = {
            _NS_RE.sub("", k): _NS_RE.sub("", v) for k, v in e.attrib.items()
        }


class Points:
    """Vertex coordinates of an SVG element, with transform support."""

    def __init__(self, xy: Coordinates) -> None:
        self.xy = list(xy)

    # ---- Geometry ---- #

    def closed(self) -> bool:
        """Whether the last point equals the first (or fewer than 2 points)."""
        return len(self.xy) <= 1 or self.xy[0] == self.xy[-1]

    def bbox(self) -> Optional[Dict[str, Number]]:
        """Bounding box as {'x', 'y', 'width', 'height'}, or None if empty."""
        if not self.xy:
            return None
        xs = [p[0] for p in self.xy]
        ys = [p[1] for p in self.xy]
        return {
            "x": min(xs),
            "y": min(ys),
            "width": max(xs) - min(xs),
            "height": max(ys) - min(ys),
        }

    # ---- Transforms ---- #

    def translate(self, x: Number, y: Number = 0) -> "Points":
        """Translate by (x, y)."""
        return Points([(px + x, py + y) for px, py in self.xy])

    def scale(self, x: Number, y: Number = None) -> "Points":
        """Scale by (x, y); y defaults to x."""
        if y is None:
            y = x
        return Points([(px * x, py * y) for px, py in self.xy])

    def matrix(self, a, b, c, d, e, f) -> "Points":
        """Apply an SVG 2x3 matrix transform."""
        return Points(
            [(a * px + c * py + e, b * px + d * py + f) for px, py in self.xy]
        )

    def transform(self, transform: str) -> "Points":
        """Apply an SVG ``transform`` attribute (translate/scale/matrix)."""
        points = self
        for func, params in re.findall(r"([A-Za-z]+)\(([^\)]*)\)", transform):
            method = getattr(points, func, None)
            if method is None or func.startswith("_"):
                raise ValueError(
                    f"Unsupported (or invalid) transform function: {func}"
                )
            points = method(*_numbers(params))
        return points

    # ---- Element conversion ---- #

    @classmethod
    def from_element(cls, tag: str, **attrs: Any) -> "Points":
        """Extract vertex coordinates from an element's tag and attributes."""
        if tag in ("polyline", "polygon"):
            xy = [tuple(p) for p in _pairs(_numbers(attrs.get("points", "")))]
            if tag == "polygon" and xy and xy[0] != xy[-1]:
                xy.append(xy[0])
            return cls(xy)
        if tag == "line":
            return cls(
                [
                    (_num(attrs.get("x1", 0)), _num(attrs.get("y1", 0))),
                    (_num(attrs.get("x2", 0)), _num(attrs.get("y2", 0))),
                ]
            )
        if tag == "circle":
            return cls([(_num(attrs.get("cx", 0)), _num(attrs.get("cy", 0)))])
        if tag in ("rect", "image"):
            x = _num(attrs.get("x", 0))
            y = _num(attrs.get("y", 0))
            w = _num(attrs["width"])
            h = _num(attrs["height"])
            return cls([(x, y), (x + w, y), (x + w, y + h), (x, y + h), (x, y)])
        if tag == "svg":
            viewbox = attrs.get("viewBox")
            if viewbox:
                x, y, w, h = _numbers(viewbox)
                return cls([(x, y), (x + w, y), (x + w, y + h), (x, y + h), (x, y)])
            return cls([])
        if tag == "path":
            return cls(_parse_path_vertices(attrs.get("d", "")))
        raise ValueError(f"Unsupported (or invalid) element tag: {tag}")

    def to_element(self, tag: str) -> Dict[str, str]:
        """Convert coordinates to the attributes of the given element tag."""
        if tag == "polyline":
            return {"points": " ".join(f"{x},{y}" for x, y in self.xy)}
        if tag == "polygon":
            xy = self.xy[:-1] if self.closed() else self.xy
            return {"points": " ".join(f"{x},{y}" for x, y in xy)}
        if tag == "line":
            p1 = self.xy[0] if self.xy else (0, 0)
            p2 = self.xy[-1] if self.xy else (0, 0)
            return {
                "x1": str(p1[0]), "y1": str(p1[1]),
                "x2": str(p2[0]), "y2": str(p2[1]),
            }
        if tag == "circle":
            c = self.xy[0] if self.xy else (0, 0)
            return {"cx": str(c[0]), "cy": str(c[1])}
        if tag in ("rect", "image"):
            box = self.bbox() or {"x": 0, "y": 0, "width": 0, "height": 0}
            return {k: str(v) for k, v in box.items()}
        if tag == "svg":
            box = self.bbox()
            if box:
                return {
                    "viewBox": (
                        f"{box['x']} {box['y']} {box['width']} {box['height']}"
                    )
                }
            return {}
        if tag == "path":
            parts = []
            xy = self.xy[:-1] if self.closed() else self.xy
            for i, (x, y) in enumerate(xy):
                prefix = "M " if i == 0 else ("L " if i == 1 else "")
                parts.append(f"{prefix}{x},{y}")
            if self.closed():
                parts.append("Z")
            return {"d": " ".join(parts)}
        raise ValueError(f"Unsupported (or invalid) element tag: {tag}")


def _parse_path_vertices(d: str) -> Coordinates:
    """Vertices of an SVG path ``d`` attribute (curvature discarded)."""
    xy: Coordinates = []
    # How many parameters each command consumes, and which of them are the
    # endpoint coordinates.
    tokens = re.findall(r"([A-DF-Za-df-z])([^A-DF-Za-df-z]*)", d)
    for cmd, argstr in tokens:
        params = _numbers(argstr)
        lower = cmd.lower()
        relative = cmd.islower()

        def emit(x, y, rel=relative):
            if rel and xy:
                xy.append((xy[-1][0] + x, xy[-1][1] + y))
            else:
                xy.append((x, y))

        if lower in ("m", "l", "t"):
            for x, y in _pairs(params):
                emit(x, y)
        elif lower == "h":
            for x in params:
                if relative:
                    xy.append((xy[-1][0] + x, xy[-1][1]))
                else:
                    xy.append((x, xy[-1][1]))
        elif lower == "v":
            for y in params:
                if relative:
                    xy.append((xy[-1][0], xy[-1][1] + y))
                else:
                    xy.append((xy[-1][0], y))
        elif lower == "c":
            for chunk in zip(*([iter(params)] * 6)):
                emit(chunk[4], chunk[5])
        elif lower in ("s", "q"):
            for chunk in zip(*([iter(params)] * 4)):
                emit(chunk[2], chunk[3])
        elif lower == "a":
            for chunk in zip(*([iter(params)] * 7)):
                emit(chunk[5], chunk[6])
        elif lower == "z":
            if xy:
                xy.append(xy[0])
        else:
            raise ValueError(f"Invalid command encountered: {cmd}")
    return xy


# ---- Reading ---- #

_SHAPE_TAGS = ("image", "path", "polyline", "polygon", "line", "circle", "rect")


def read(
    path: Union[str, FilePath, TextIO],
    key: str = None,
    imgsz: Tuple[int, int] = None,
) -> dict:
    """Read SVG element vertices as image coordinates.

    Coordinates are returned with (0, 0) at the upper-left corner of the
    upper-left image pixel, rescaled so the embedded ``image`` element spans
    ``imgsz`` (or its own intrinsic size). Elements are grouped following
    ``svg``/``g`` structure, keyed by the ``key`` attribute when present.
    """
    tree = ET.parse(path)
    _strip_namespaces(tree)
    svgs = list(tree.iter("svg"))
    if not svgs:
        raise ValueError("No <svg> tag found")
    if len(svgs) > 1:
        raise ValueError("Multiple <svg> tags not supported")
    root = svgs[0]
    images = list(tree.iter("image"))
    if imgsz is not None and not images:
        raise ValueError("Cannot apply `imgsz` since no <image> found")
    if len(images) > 1:
        warnings.warn("Transforming coordinates to last (top) of multiple <image>")
    image_boxes = {}

    def walk(e: ET.Element, transform: str = "") -> dict:
        name = (e.get(key) if key else None) or e.tag
        transform = transform + e.get("transform", "")
        if e.tag in _SHAPE_TAGS:
            points = Points.from_element(e.tag, **e.attrib)
            if e.tag == "image":
                image_boxes["original"] = points.bbox()
                image_boxes["transformed"] = points.transform(transform).bbox()
            return {name: points.transform(transform).xy}
        if e.tag in ("svg", "g") and len(e):
            grouped = defaultdict(list)
            for child in e:
                for k, v in walk(child, transform).items():
                    grouped[k].append(v)
            return {
                name: {k: (v[0] if len(v) == 1 else v) for k, v in grouped.items()}
            }
        return {name: {}}

    result = walk(root)
    translate = (0, 0)
    scale = (1, 1)
    if image_boxes:
        tbox = image_boxes["transformed"]
        if (tbox["x"], tbox["y"]) != (0, 0):
            translate = (-tbox["x"], -tbox["y"])
        if imgsz is None:
            obox = image_boxes["original"]
            imgsz = (obox["width"], obox["height"])
        if imgsz[0] != tbox["width"] or imgsz[1] != tbox["height"]:
            scale = (imgsz[0] / tbox["width"], imgsz[1] / tbox["height"])

    def rescale(node) -> None:
        keys = node.keys() if isinstance(node, dict) else range(len(node))
        for k in keys:
            value = node[k]
            if not value:
                continue
            if isinstance(value, list) and isinstance(value[0], tuple):
                node[k] = Points(value).translate(*translate).scale(*scale).xy
            else:
                rescale(value)

    rescale(result)
    return next(iter(result.values()))


# ---- Element constructors ---- #


def svg(*children: ET.Element, **attrib: str) -> ET.Element:
    """Create an ``svg`` element (width/height default to the last image child)."""
    root = ET.Element("svg")
    root.extend(children)
    if not ({"width", "height"} & attrib.keys()):
        size = _last_image_size(root)
        if size:
            attrib = {"height": size[1], "width": size[0], **attrib}
    namespaces = {
        "xmlns": "http://www.w3.org/2000/svg",
        "xmlns:xlink": "http://www.w3.org/1999/xlink",
    }
    root.attrib = {**attrib, **namespaces}
    return root


def _last_image_size(root: ET.Element) -> Optional[Tuple[str, str]]:
    """(width, height) of the last ``image`` descendant, if fully specified."""
    size = None
    for node in root.iter("image"):
        w, h = node.get("width"), node.get("height")
        if w and h:
            size = (w, h)
    return size


def g(*children: ET.Element, **attrib: str) -> ET.Element:
    """Create a ``g`` (group) element."""
    e = ET.Element("g", attrib=attrib)
    e.extend(children)
    return e


def image(width, height, href: str = None, **attrib: str) -> ET.Element:
    """Create an ``image`` element."""
    optional = {"xlink:href": href} if href else {}
    attrib = {"height": str(height), "width": str(width), **optional, **attrib}
    return ET.Element("image", attrib=attrib)


def path(d: Union[str, Coordinates] = "", **attrib: str) -> ET.Element:
    """Create a ``path`` element from a `d` string or vertex coordinates."""
    if not isinstance(d, str):
        d = Points(d).to_element("path")["d"]
    return ET.Element("path", attrib={"d": d, **attrib})


# ---- Writing ---- #


def _indent(e: ET.Element, level: int, sep: str, tab: str, last: bool) -> None:
    if len(e):
        if not e.text or not e.text.strip():
            e.text = sep + tab * (level + 1)
        for i, child in enumerate(e, start=1):
            _indent(child, level + 1, sep, tab, i == len(e))
        if not e.tail or not e.tail.strip():
            e.tail = sep + tab * (level - 1)
    elif level and (not e.tail or not e.tail.strip()):
        e.tail = sep + tab * (level - last)
    if level == 0:
        e.tail = None


def write(
    e: ET.Element, path: Union[str, FilePath] = None, indent: Union[int, str] = None
) -> Optional[str]:
    """Serialize an element tree, optionally pretty-printed, to string or file."""
    e = copy.deepcopy(e)
    if indent is None:
        sep, tab = "", ""
    else:
        sep = "\n"
        tab = indent if isinstance(indent, str) else max(indent, 0) * " "
    _indent(e, 0, sep, tab, False)
    txt = ET.tostring(e, encoding="unicode")
    if not path:
        return txt
    with open(path, "w") as fp:
        fp.write(txt)
    return None
