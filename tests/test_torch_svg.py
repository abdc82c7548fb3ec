"""The port's ``svg`` module against the JAX package's.

Standard library only in both, so everything is held exactly: ``read`` gives
equal trees, keys and coordinates (and equal number types: an integer stays
an integer), ``write`` equal text, on small documents and on the
hand-digitised control of ``tests/assets/AK10b_20141013_020336.svg``.
"""
import io
import pathlib
import warnings

import pytest

import glimpse_tpu.svg as jax_svg
import glimpse_tpu_torch.svg as svg

ASSET = pathlib.Path(__file__).parent / "assets" / "AK10b_20141013_020336.svg"

IMAGE_DOCUMENT = """
<svg xmlns="http://www.w3.org/2000/svg">
    <path d="M 0,1 L 1,1 1,2 0,2 Z" />
    <polygon points="0,1 1,1 1,2 0,2" />
    <rect x="0" y="1" width="1" height="1" />
    <polyline points="-1,2 0,3" transform="matrix(1 0 0 1 1 -1)" />
    <line x1="0" y1="0.5" x2="0.5" y2="1" transform="scale(4,0.5)scale(0.5 4)" />
    <circle cx="-1" cy="2" r="1" transform="translate(1,-1)" />
    <image x="0" y="1" width="11" height="10" />
</svg>
"""


def same_tree(got, want) -> None:
    """Equal structure, keys in order, values and number types."""
    assert type(got) is type(want)
    if isinstance(want, dict):
        assert list(got) == list(want)
        for key in want:
            same_tree(got[key], want[key])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            same_tree(a, b)
    else:
        assert got == want


def read_both(text: str, **kwargs):
    return svg.read(io.StringIO(text), **kwargs), jax_svg.read(io.StringIO(text), **kwargs)


@pytest.mark.parametrize("key, imgsz", [(None, None), ("id", None), ("id", (800, 536)), (None, (4288, 2848)), ("class", (800, 536))])
def test_reads_the_annotation_asset_equal(key, imgsz) -> None:
    got = svg.read(ASSET, key=key, imgsz=imgsz)
    want = jax_svg.read(ASSET, key=key, imgsz=imgsz)
    assert isinstance(got, dict) and len(got) > 0
    same_tree(got, want)


def test_the_asset_holds_control_an_image_size_rescales() -> None:
    small = svg.read(ASSET, key="id", imgsz=(800, 536))
    large = svg.read(ASSET, key="id", imgsz=(1600, 1072))

    def leaves(node):
        if isinstance(node, dict):
            for value in node.values():
                yield from leaves(value)
        elif node and isinstance(node[0], tuple):
            yield node
        else:
            for value in node:
                yield from leaves(value)

    a, b = list(leaves(small)), list(leaves(large))
    assert len(a) == len(b) > 3
    for xy_small, xy_large in zip(a, b):
        for (x0, y0), (x1, y1) in zip(xy_small, xy_large):
            assert x1 == pytest.approx(2 * x0, abs=1e-9) and y1 == pytest.approx(2 * y0, abs=1e-9)


@pytest.mark.parametrize("indent", [None, 0, 2, "\t"])
def test_writes_the_asset_equal(indent, tmp_path) -> None:
    import xml.etree.ElementTree as ET

    text = svg.write(ET.parse(ASSET).getroot(), indent=indent)
    assert text == jax_svg.write(ET.parse(ASSET).getroot(), indent=indent)
    assert svg.write(ET.parse(ASSET).getroot(), path=tmp_path / "out.svg", indent=indent) is None
    assert (tmp_path / "out.svg").read_text() == text
    same_tree(svg.read(tmp_path / "out.svg", key="id"), svg.read(ASSET, key="id"))


def test_constructors_and_write_equal() -> None:
    xy = [(0, 0), (100, 100.5), (200, 200)]

    def document(module):
        return module.svg(
            module.image(href="photo.jpg", width=800, height=536),
            module.g(module.path(d=xy), module.path(d=xy + [xy[0]], id="ring"), id="control"),
            module.g(module.path(d="M 0,0 L 1,1"), **{"class": "horizon"}),
        )

    for indent in (None, 2):
        assert svg.write(document(svg), indent=indent) == jax_svg.write(document(jax_svg), indent=indent)
    coords = svg.read(io.StringIO(svg.write(document(svg))), key="id")
    assert coords["control"]["path"] == xy
    assert coords["control"]["ring"] == xy + [xy[0]]
    root = svg.svg()
    assert "width" not in root.attrib and "height" not in root.attrib
    sized = svg.svg(svg.image(width="6", height="4"))
    assert (sized.attrib["width"], sized.attrib["height"]) == ("6", "4")
    assert svg.svg(svg.image(width="6", height="4"), width="3").attrib["width"] == "3"


def test_reads_image_coordinates_equal() -> None:
    got, want = read_both(IMAGE_DOCUMENT, imgsz=(11, 10))
    same_tree(got, want)
    assert got["path"] == got["polygon"] == got["rect"] == [(0, 0), (1, 0), (1, 1), (0, 1), (0, 0)]
    assert got["polyline"] == got["line"] == [(0, 0), (1, 1)]
    assert got["circle"] == [(0, 0)]
    assert got["image"] == [(0, 0), (11, 0), (11, 10), (0, 10), (0, 0)]
    doubled, want = read_both(IMAGE_DOCUMENT, imgsz=(22, 20))
    same_tree(doubled, want)
    assert doubled["path"] == [(2 * x, 2 * y) for x, y in got["path"]]


@pytest.mark.parametrize("element", [
    "<path d='M 1,1.0' />", "<polygon points='1,1.0' />", "<polyline points='1,1.0' />",
    "<line x1='1' y1='1.0' x2='2' y2='2' />", "<circle cx='1' cy='1.0' />", "<rect x='1' y='1.0' width='1' height='1' />",
])
def test_preserves_integers(element) -> None:
    got, want = read_both(f"<svg>{element}</svg>")
    same_tree(got, want)
    x, y = got[next(iter(got))][0]
    assert isinstance(x, int) and x == 1
    assert isinstance(y, float) and y == 1


@pytest.mark.parametrize("s, xy", [
    ["1,-0.1", (1, -0.1)], ["1 -0.1", (1, -0.1)], ["1-0.1", (1, -0.1)], ["0.1.2", (0.1, 0.2)],
    ["1-1.2e-01", (1, -0.12)], ["1 1.2e+01", (1, 12)], ["1 1.2e01", (1, 12)], ["1 1.2e1", (1, 12)],
])
def test_parses_coordinate_formats(s, xy) -> None:
    for element, tag in [(f"<path d='M {s}' />", "path"), (f"<polyline points='{s}' />", "polyline"), (f"<polygon points='{s}' />", "polygon")]:
        got, want = read_both(f"<svg>{element}</svg>")
        same_tree(got, want)
        assert got[tag][0] == xy


@pytest.mark.parametrize("cmd, dxy", [
    ["M 1,2", (1, 2)], ["L 1,2", (1, 2)], ["T 1,2", (1, 2)], ["H 1", (1, 0)], ["V 2", (0, 2)], ["C 0,0 0,0 1,2", (1, 2)],
    ["S 0,0 1,2", (1, 2)], ["Q 0,0 1,2", (1, 2)], ["A 0 0 0 0 0 1,2", (1, 2)], ["Z", (0, 0)],
])
def test_parses_path_commands(cmd, dxy) -> None:
    xo, yo = 1, 2
    for start in ("M", "m"):
        got, want = read_both(f"<svg><path d='{start} {xo},{yo} {cmd}' /></svg>")
        same_tree(got, want)
        assert got["path"][1] == (dxy[0] or xo, dxy[1] or yo)
        got, want = read_both(f"<svg><path d='{start} {xo},{yo} {cmd.lower()}' /></svg>")
        same_tree(got, want)
        assert got["path"][1] == (xo + dxy[0], yo + dxy[1])


def test_keys_and_groups_equal() -> None:
    nested = "<svg><g id='gcp'><circle id='rock' cx='0' cy='1'/></g><g/></svg>"
    same_tree(*read_both(nested))
    same_tree(*read_both(nested, key="id"))
    assert svg.read(io.StringIO(nested))["g"][0]["circle"] == svg.read(io.StringIO(nested), key="id")["gcp"]["rock"]
    repeated = "<svg><path id='gcp' d='M 0, 0' /><path id='gcp' d='M 0, 0' /></svg>"
    same_tree(*read_both(repeated))
    assert svg.read(io.StringIO(repeated), key="id")["gcp"] == [[(0, 0)], [(0, 0)]]


@pytest.mark.parametrize("text, kwargs", [
    ("<xml />", {}), ("<svg><svg /></svg>", {}), ("<svg />", {"imgsz": (12, 8)}), ("<svg><path d='X 0,0' /></svg>", {}),
    ("<svg><path d='M 0,0' transform='rotate(30)' /></svg>", {}), ("<svg><path d='M 0,0' transform='_num(3)' /></svg>", {}),
])
def test_the_same_errors(text, kwargs) -> None:
    for module in (svg, jax_svg):
        with pytest.raises(ValueError):
            module.read(io.StringIO(text), **kwargs)


def test_warns_for_multiple_images() -> None:
    image = '<image width="6" height="4" />'
    for module in (svg, jax_svg):
        with pytest.warns(UserWarning, match="multiple <image>"):
            module.read(io.StringIO(f"<svg>{image * 2}</svg>"))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        svg.read(io.StringIO(f"<svg>{image}</svg>"))


def test_points_transforms_and_elements_equal() -> None:
    xy = [(0, 0), (2, 0), (2, 1.5), (0, 0)]
    got, want = svg.Points(xy), jax_svg.Points(xy)
    assert got.closed() and got.bbox() == want.bbox()
    assert svg.Points([]).bbox() is None
    for transform in ("translate(1,-1)", "translate(3)", "scale(2)", "scale(2 0.5)", "matrix(0 1 -1 0 5 5) translate(1 1)"):
        assert got.transform(transform).xy == want.transform(transform).xy
    for tag in ("polyline", "polygon", "line", "circle", "rect", "image", "svg", "path"):
        assert got.to_element(tag) == want.to_element(tag)
        again = svg.Points.from_element(tag, **got.to_element(tag))
        assert again.xy == jax_svg.Points.from_element(tag, **want.to_element(tag)).xy
    assert svg.Points.from_element("svg").xy == []
    assert svg.Points([(1, 2), (3, 4)]).to_element("path") == {"d": "M 1,2 L 3,4"}
    for module in (svg, jax_svg):
        with pytest.raises(ValueError):
            module.Points.from_element("text")
        with pytest.raises(ValueError):
            module.Points(xy).to_element("text")
