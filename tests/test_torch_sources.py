"""The port's kernel build table against the CUDA sources it names: every
library of ``_ENTRY_POINTS`` is built from a source of ``SOURCES`` that
exists and defines the entry point with as many arguments as its ctypes list;
every ``extern "C"`` function under ``csrc/`` is bound; every quoted include
resolves; no header is orphaned (``build_kernels`` hashes every header into
every library, so an orphan rebuilds them all for nothing); and no source is
left on the pre-Hopper ``mma.sync`` / ``ldmatrix`` / ``cp.async.cg`` design.
Reads files only, so it runs on the CPU; the card-only tests
(``tests/test_torch_kernels.py``) would catch a wrong table only on the card.
"""

import re

import pytest

from osufusion_tpu_torch.ops.flash_attention import _CSRC, _ENTRY_POINTS, SOURCES

_FILES = sorted(p.name for p in _CSRC.iterdir() if p.suffix in (".cu", ".cuh"))
_HEADERS = [name for name in _FILES if name.endswith(".cuh")]
_INCLUDE = re.compile(r'^\s*#include\s+"([^"]+)"', re.MULTILINE)
_EXTERN_C = re.compile(r'extern\s+"C"\s+\w+\s+(\w+)\s*\(([^)]*)\)\s*\{')


def _text(name: str) -> str:
    return (_CSRC / name).read_text()


def _includes(name: str) -> list[str]:
    return _INCLUDE.findall(_text(name))


def _extern_c(name: str) -> dict[str, int]:
    """The ``extern "C"`` functions that source ``name`` defines, with their
    argument counts."""
    return {fn: len([a for a in args.split(",") if a.strip()]) for fn, args in _EXTERN_C.findall(_text(name))}


def _defined() -> dict[str, tuple[str, int]]:
    """Every ``extern "C"`` function under ``csrc/`` -> (file, arguments)."""
    found = {}
    for name in _FILES:
        for fn, n in _extern_c(name).items():
            assert fn not in found, f"{fn} is defined in {found[fn][0]} and in {name}"
            found[fn] = (name, n)
    return found


def test_csrc_holds_sources_and_headers():
    assert any(name.endswith(".cu") for name in _FILES) and _HEADERS


@pytest.mark.parametrize("library", sorted(SOURCES))
def test_every_source_exists(library):
    assert SOURCES[library].is_file(), f"SOURCES[{library!r}] = {SOURCES[library]} does not exist"
    assert SOURCES[library].parent == _CSRC


@pytest.mark.parametrize("entry", sorted(_ENTRY_POINTS))
def test_every_entry_point_is_defined_by_its_library(entry):
    library, argtypes = _ENTRY_POINTS[entry]
    assert library in SOURCES, f"{entry} names library {library!r}, which SOURCES does not build"
    defined = _extern_c(SOURCES[library].name)
    assert entry in defined, f"{entry} is not an extern \"C\" function of {SOURCES[library].name}"
    assert defined[entry] == len(argtypes), (
        f"{entry} takes {defined[entry]} arguments in C, {len(argtypes)} in its ctypes list")


@pytest.mark.parametrize("fn", sorted(_defined()))
def test_every_extern_c_function_is_bound(fn):
    source, n_args = _defined()[fn]
    assert fn in _ENTRY_POINTS, f"{fn} ({source}) has no _ENTRY_POINTS entry"
    library, argtypes = _ENTRY_POINTS[fn]
    assert SOURCES[library].name == source, f"{fn} is defined in {source} but bound to library {library!r}"
    assert len(argtypes) == n_args


@pytest.mark.parametrize("name", _FILES)
def test_every_include_resolves(name):
    missing = [inc for inc in _includes(name) if not (_CSRC / inc).is_file()]
    assert not missing, f"{name} includes {missing}, which are not in csrc/"


@pytest.mark.parametrize("header", _HEADERS)
def test_no_header_is_orphaned(header):
    reached, todo = set(), [source.name for source in SOURCES.values()]
    while todo:
        name = todo.pop()
        if name not in reached:
            reached.add(name)
            todo.extend(_includes(name))
    assert header in reached, f"{header} is included by no source that SOURCES builds"


@pytest.mark.parametrize("name", _FILES)
def test_no_source_is_left_on_mma_sync(name):
    text = _text(name)
    found = [token for token in ("mma.sync", "ldmatrix", "cp.async.cg") if token in text]
    assert not found, f"{name} still uses {found}"


@pytest.mark.parametrize("D", [64, 128, 192, 256])
@pytest.mark.parametrize("name", ["flash_fwd.cu", "flash_bwd.cu"])
def test_k1_and_k2_instantiate_every_wgmma_head_dim(name, D):
    """K1 (the forward and its halo instance) and K2's sweep dispatch on the
    head dim they are given to an instance of each of 64, 128, 192, 256, as
    ``flash_forms.WGMMA_HEAD_DIMS`` promises the wrappers."""
    from osufusion_tpu_torch.ops.flash_forms import WGMMA_HEAD_DIMS

    assert D in WGMMA_HEAD_DIMS
    text = _text(name)
    assert re.search(rf"case {D}: return CALL\({D}\);", text), f"{name} has no instance of head dim {D}"


@pytest.mark.parametrize("instance", ["float", "__nv_bfloat16", "__half", "chunked"])
def test_forms_dispatch_names_every_type_and_the_chunked_instance(instance):
    """``FORMS_DISPATCH`` (csrc/flash_forms.cu) serves fp32, bf16 and fp16
    operands at D = 64 ... 256, and the chunked instance (D = 0 there) at
    every head dim above 256 that is a multiple of 64, for every type."""
    text = _text("flash_forms.cu")
    body = text[text.index("#define FORMS_TYPE"):text.index("#define FORMS_DISPATCH")]
    dispatch = text[text.index("#define FORMS_DISPATCH"):text.index('extern "C" int forms_fwd')]
    if instance == "chunked":
        assert "return CALL(TT, 0);" in body and "D > 256 ? 0 : D" in dispatch
        for kernel in ("forms_fwd_chunked_kernel", "forms_dq_chunked_kernel", "forms_dkv_chunked_kernel"):
            assert f"{kernel}<" in text, f"{kernel} is never launched"
    else:
        assert re.search(rf"FORMS_TYPE\(DTYPE_\w+, {instance}\)", dispatch), f"FORMS_DISPATCH does not name {instance}"
        for D in (64, 128, 192, 256):
            assert f"return CALL(TT, {D});" in body
