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

import ctypes
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
@pytest.mark.parametrize("name", ["flash_fwd.cu", "flash_bwd.cu", "flash_bwd_windowed.cu", "flash_bwd_prep.cuh",
                                  "flash_fwd_f16.cu", "flash_bwd_f16.cu", "flash_bwd_windowed_f16.cu"])
def test_k1_and_k2_instantiate_every_wgmma_head_dim(name, D):
    """K1 (the forward and its halo instance), K2's sweep and the windowed
    pair (K3a / K3b and their halo instances) dispatch on the head dim they
    are given to an instance of each of 64, 128, 192, 256, as
    ``flash_forms.WGMMA_HEAD_DIMS`` promises the wrappers, in the source or a
    header it includes (the fp16 libraries of K1, K2's sweep and the
    windowed pair too); the pre-pass is templated on the operand type and
    the head dim, and the windowed pair's entry point instantiates it at
    each head dim through the header's ``launch_prep``."""
    from osufusion_tpu_torch.ops.flash_forms import WGMMA_HEAD_DIMS

    assert D in WGMMA_HEAD_DIMS
    if name == "flash_bwd_prep.cuh":
        assert "template <typename E, int D, bool ROPE>" in _text(name)
        windowed = _text("flash_bwd_windowed.cu")
        entry = windowed[windowed.index('extern "C" int flash_bwd_windowed_prep_bf16'):]
        entry = entry[:entry.index('extern "C"', 1)]
        assert "launch_prep<__nv_bfloat16, DD>" in entry and "WINDOWED_HEAD_DIMS(CALL)" in entry
        header = _text("flash_bwd_windowed.cuh")
        launch = header[header.index("int launch_prep("):]
        assert "flash_bwd_prep_kernel<E, D, true>" in launch[:launch.index("\n}\n")]
        name = "flash_bwd_windowed.cu"
    text = _text(name) + "".join(_text(header) for header in _includes(name))
    assert re.search(rf"case {D}: return CALL\({D}\);", text), f"{name} has no instance of head dim {D}"


@pytest.mark.parametrize("instance", ["float", "__nv_bfloat16", "__half", "chunked"])
def test_forms_dispatch_names_every_type_and_the_chunked_instance(instance):
    """``FORMS_DISPATCH`` (csrc/flash_forms.cu) serves fp32, bf16 and fp16
    operands at D = 64 ... 256 and the chunked instance (D = 0 there) at every
    head dim above 256 that is a multiple of 64, for every type, at the
    pre-pass, the post-pass and the merge (``FORMS_EVERY``). dq and dk/dv
    keep every type's chunked instance only above 512 (``FORMS_PAIR_CHUNKS``,
    ``FORMS_ABOVE``: csrc/flash_f32x6.cuh's pair takes fp32 at D <= 512, K2's
    sweep, the wgmma windowed pair and csrc/flash_xwide.cuh's pair bf16 and
    fp16 there, so the dispatch keys D = 320 ... 512 apart from the head dims
    above them), and no type at D <= 256. No forward is left in the family:
    no forward entry point, no chunked forward body and no list of its
    instances (csrc/flash_f32x6.cuh's and csrc/flash_xwide.cuh's forwards take
    every head dim above K1's)."""
    text = _text("flash_forms.cu")
    dims = text[text.index("#define FORMS_DIMS"):text.index("#define FORMS_ABOVE")]
    chunked = text[text.index("#define FORMS_ABOVE"):text.index("#define FORMS_PAIR_CHUNKS")]
    lists = text[text.index("#define FORMS_PAIR_CHUNKS"):text.index("#define FORMS_DISPATCH")]
    dispatch = text[text.index("#define FORMS_DISPATCH"):text.index('extern "C" int forms_bwd_prep')]
    for D in (64, 128, 192, 256):
        assert f"return CALL(TT, {D});" in dims
    assert "#define FORMS_ABOVE(CODE, TT) case CODE * 1000 + 1: return CALL(TT, 0);" in chunked
    assert "#define FORMS_CHUNKED(CODE, TT) case CODE * 1000 + 0: FORMS_ABOVE(CODE, TT)" in chunked
    assert "D > 512 ? 1 : D > 256 ? 0 : D" in dispatch

    def named(macro: str) -> str:  # the instance list of one entry point's macro
        return lists[lists.index(f"#define {macro} "):].split("\n#define")[0]

    every, pair = named("FORMS_EVERY"), named("FORMS_PAIR_CHUNKS")
    entries = {e: text[text.index(f'extern "C" int {e}('):] for e in
               ("forms_bwd_prep", "forms_bwd_dq", "forms_bwd_dkv", "forms_bwd_post", "forms_ring_merge")}
    uses = {e: re.search(r"FORMS_DISPATCH\((\w+)\)", body).group(1) for e, body in entries.items()}
    assert uses == {"forms_bwd_prep": "FORMS_EVERY", "forms_bwd_dq": "FORMS_PAIR_CHUNKS",
                    "forms_bwd_dkv": "FORMS_PAIR_CHUNKS", "forms_bwd_post": "FORMS_EVERY",
                    "forms_ring_merge": "FORMS_EVERY"}
    for gone in ("forms_fwd", "forms_fwd_kernel<", "forms_fwd_chunked_kernel", "FORMS_CHUNKS", "FORMS_FWD",
                 "FORMS_SWEEPS", "launch_fwd"):
        assert gone not in text, gone
    assert "forms_fwd" not in _ENTRY_POINTS
    if instance == "chunked":
        for kernel in ("forms_dq_chunked_kernel", "forms_dkv_chunked_kernel"):
            assert f"{kernel}<" in text, f"{kernel} is never launched"
        for name in ("float", "__nv_bfloat16", "__half"):
            assert re.search(rf"FORMS_CHUNKED\(DTYPE_\w+, {name}\)", every)
            # no chunked dq or dk/dv at D = 320 ... 512 at any type
            assert re.search(rf"FORMS_ABOVE\(DTYPE_\w+, {name}\)", pair)
            assert not re.search(rf"FORMS_CHUNKED\(DTYPE_\w+, {name}\)", pair)
        return
    assert re.search(rf"FORMS_DIMS\(DTYPE_\w+, {instance}\)", every), f"FORMS_EVERY does not name {instance}"
    assert not re.search(rf"FORMS_DIMS\(DTYPE_\w+, {instance}\)", pair)


# the wgmma wrappers of hopper.cuh, each with a bf16 and an fp16 instruction
WGMMA_WRAPPERS = ["wgmma_ss_n64", "wgmma_ss_n128", "wgmma_rs_n64", "wgmma_rs_n128", "wgmma_rs_n192", "wgmma_rs_n256"]


@pytest.mark.parametrize("wrapper", WGMMA_WRAPPERS)
def test_every_wgmma_wrapper_has_an_f16_form(wrapper):
    """Every ``wgmma`` wrapper of hopper.cuh spells its instruction at bf16
    and at fp16 operands (fp32 accumulators), chosen by its operand type;
    no wrapper is left at one type, and hopper.cuh has no ``mma.sync``."""
    text = _text("hopper.cuh")
    wrappers = re.findall(r"void (wgmma_[sr]s_n\d+)\(", text)
    assert sorted(wrappers) == sorted(WGMMA_WRAPPERS)
    body = text[text.index(f"void {wrapper}("):]
    body = body[:body.index("\n}\n")]
    assert "typename T = __nv_bfloat16" in text[:text.index(f"void {wrapper}(")].rsplit("template", 1)[1]
    assert "mma_async.sync.aligned.m64n" in body
    assert '"f32.bf16.bf16"' in body and '"f32.f16.f16"' in body and "IS_F16<T>" in body
    assert "mma.sync" not in text


# entry point -> the header whose kernels its bf16 and fp16 sources instantiate
F16_TWINS = {"flash_fwd": "flash_fwd.cuh", "halo_fwd": "flash_fwd.cuh", "flash_bwd_sweep": "flash_bwd_sweep.cuh",
             "flash_bwd_windowed_prep": "flash_bwd_windowed.cuh", "flash_bwd_dq": "flash_bwd_windowed.cuh",
             "flash_bwd_dkv": "flash_bwd_windowed.cuh", "halo_bwd_dq": "flash_bwd_windowed.cuh",
             "halo_bwd_dkv": "flash_bwd_windowed.cuh"}


@pytest.mark.parametrize("entry", sorted(F16_TWINS))
def test_fp16_entry_point_twins_its_bf16_one(entry):
    """The fp16 entry points of K1, K2's sweep and the windowed pair with its
    pre-pass take the bf16 ones' arguments, from libraries of their own
    built from sources that instantiate the same header's kernels at
    __half."""
    bf16_lib, bf16_args = _ENTRY_POINTS[f"{entry}_bf16"]
    f16_lib, f16_args = _ENTRY_POINTS[f"{entry}_f16"]
    assert f16_args == bf16_args and f16_lib != bf16_lib and f16_lib in SOURCES
    header = F16_TWINS[entry]
    assert header in _includes(SOURCES[bf16_lib].name) and header in _includes(SOURCES[f16_lib].name)
    assert "<__half, DD" in _text(SOURCES[f16_lib].name) and "<__nv_bfloat16, DD" in _text(SOURCES[bf16_lib].name)


# the entry points of csrc/flash_xwide.cuh's kernels, one per kernel and frame
XWIDE_ENTRIES = ["xwide_fwd", "xwide_halo_fwd", "xwide_bwd_dq", "xwide_bwd_dkv"]


@pytest.mark.parametrize("entry", XWIDE_ENTRIES)
def test_xwide_instances_are_built_for_sm_90a(entry):
    """The kernels above head dim 256 (csrc/flash_xwide.cuh) are in the build
    table at both operand types: a bf16 and an fp16 entry point with the same
    arguments, in libraries of their own (``flash_xwide``,
    ``flash_xwide_f16``) built for sm_90a from sources that include the header
    and instantiate it at ``__nv_bfloat16`` and ``__half``; the forward takes
    ``flash_fwd_*``'s and ``halo_fwd_*``'s arguments and the scratch of its qs
    (a pointer after the LSE). The header's pair covers the head dims that
    ``flash_forms.XWIDE_HEAD_DIMS`` promises, its forward every multiple of
    64 (an instance that stages and holds qs up to XW_MAX_D, one that streams
    it above); it is built on ``wgmma`` and has no ``mma.sync``."""
    from osufusion_tpu_torch.ops.flash_attention import NVCC_FLAGS
    from osufusion_tpu_torch.ops.flash_forms import XWIDE_HEAD_DIMS

    assert "arch=compute_90a,code=sm_90a" in NVCC_FLAGS
    bf16_lib, bf16_args = _ENTRY_POINTS[f"{entry}_bf16"]
    f16_lib, f16_args = _ENTRY_POINTS[f"{entry}_f16"]
    assert (bf16_lib, f16_lib) == ("flash_xwide", "flash_xwide_f16") and bf16_args == f16_args
    twin = {"xwide_fwd": "flash_fwd", "xwide_halo_fwd": "halo_fwd"}.get(entry)
    if twin is not None:
        twin_args = _ENTRY_POINTS[f"{twin}_bf16"][1]
        at = twin_args.index(ctypes.c_int, 1)  # the pointers end before B
        assert bf16_args == twin_args[:at] + [ctypes.c_void_p] + twin_args[at:]
    for lib, tt in ((bf16_lib, "__nv_bfloat16"), (f16_lib, "__half")):
        source = _text(SOURCES[lib].name)
        assert "flash_xwide.cuh" in _includes(SOURCES[lib].name)
        body = source[source.index(f'extern "C" int {entry}_'):]
        assert f"<{tt}>(" in body[:body.index("\n}\n")]
    header = _text("flash_xwide.cuh")
    found = re.search(r"XW_MIN_D = (\d+), XW_MAX_D = (\d+);", header)
    assert (int(found.group(1)), int(found.group(2))) == (XWIDE_HEAD_DIMS[0], XWIDE_HEAD_DIMS[-1])
    assert "wgmma_ss<K, 0, 0, E>" in header and "wgmma_rs_n64" in header and "mma.sync" not in header
    for kernel in ("xwide_fwd_kernel", "xwide_dq_kernel", "xwide_dkv_kernel"):
        template = "template <typename E, bool STREAM>" if kernel == "xwide_fwd_kernel" else "template <typename E>"
        assert re.search(rf"{template}\s+__global__ void __launch_bounds__\(XW_THREADS, 1\)\s+{kernel}\(",
                         header), kernel
    assert "launch_xwide_fwd_kernel<E, false>(" in header and "launch_xwide_fwd_kernel<E, true>(" in header
    assert "if (D <= 0 || D % 64 != 0 || (D > XW_MAX_D && qs == nullptr)) return (int)cudaErrorInvalidValue;" in header


def test_f32x6_pair_is_built_for_sm_90a():
    """The fp32 forward and backward pair on the tensor cores
    (csrc/flash_f32x6.cuh) are in the build table: a library of their own
    (``flash_f32x6``) built for sm_90a from a source that includes the
    header, with its split, forward (one device and the halo frame), dq and
    dk/dv entry points bound, the forward taking the xwide forward's
    arguments (``flash_fwd_*``'s and ``halo_fwd_*``'s and the scratch of qs)
    and the pair the xwide pair's (``forms_bwd_dq``'s and ``forms_bwd_dkv``'s
    without the type code). The header's forward takes every multiple of 64
    (qs staged and its three pieces held up to 256, which
    ``flash_forms.WGMMA_HEAD_DIMS`` names; above, qs's pieces from a pre-pass,
    piece 0 held or none), its pair those and ``flash_forms.XWIDE_HEAD_DIMS``
    (an instance with two pieces of the resident rows in shared memory up to
    256, one above, its dk/dv columns in chunks there), and its split every
    multiple of 64; it is built on bf16 ``wgmma`` products from shared
    memory and from registers, and has none of the pre-Hopper tokens."""
    from osufusion_tpu_torch.ops.flash_attention import NVCC_FLAGS
    from osufusion_tpu_torch.ops.flash_forms import WGMMA_HEAD_DIMS, XWIDE_HEAD_DIMS

    assert "arch=compute_90a,code=sm_90a" in NVCC_FLAGS
    assert "flash_f32x6.cuh" in _includes(SOURCES["flash_f32x6"].name)
    entries = {e for e, (lib, _) in _ENTRY_POINTS.items() if lib == "flash_f32x6"}
    assert entries == {"f32x6_split", "f32x6_fwd", "f32x6_halo_fwd", "f32x6_bwd_dq", "f32x6_bwd_dkv"}
    assert _ENTRY_POINTS["f32x6_fwd"][1] == _ENTRY_POINTS["xwide_fwd_bf16"][1]
    assert _ENTRY_POINTS["f32x6_halo_fwd"][1] == _ENTRY_POINTS["xwide_halo_fwd_bf16"][1]
    assert _ENTRY_POINTS["f32x6_bwd_dq"][1] == _ENTRY_POINTS["xwide_bwd_dq_bf16"][1]
    assert _ENTRY_POINTS["f32x6_bwd_dkv"][1] == _ENTRY_POINTS["xwide_bwd_dkv_bf16"][1]
    source = _text(SOURCES["flash_f32x6"].name)
    for entry in ("f32x6_fwd", "f32x6_halo_fwd"):
        body = source[source.index(f'extern "C" int {entry}('):]
        assert "launch_x6_fwd(" in body[:body.index("\n}\n")]
    header = _text("flash_f32x6.cuh")
    assert "X6_MAX_D = 256;" in header
    assert "if (D <= 0 || D % 64 != 0 || (D > X6_MAX_D && qs == nullptr)) return (int)cudaErrorInvalidValue;" in header
    assert WGMMA_HEAD_DIMS == (64, 128, 192, 256) and XWIDE_HEAD_DIMS == (320, 384, 448, 512)
    assert "X6_PAIR_MAX_D = 512;" in header and "D >= 64 && D <= X6_PAIR_MAX_D && D % 64 == 0" in header
    assert "D <= X6_MAX_D ? 2 : 1" in header  # the resident pieces of the pair's rows
    for kind in ("dq", "dkv"):
        assert f"launch_x6_{kind}_res<2>(" in header and f"launch_x6_{kind}_res<1>(" in header, kind
    assert "wgmma_ss<N, 0, 0, E>" in header and "wgmma_rs_n64<1, E>" in header  # S over N = 64 or 128 keys
    assert not [token for token in ("mma.sync", "ldmatrix", "cp.async.cg") if token in header]
    for kernel in ("x6_fwd_kernel", "x6_dq_kernel", "x6_dkv_kernel"):
        assert re.search(rf"__global__ void __launch_bounds__\(XW_THREADS, 1\)\s+{kernel}\(", header), kernel
    # the forward's key tiles, as tests/test_torch_f32x6.py emulates them: 128 keys up to D = 128, 64 above; three
    # pieces of qs resident up to X6_MAX_D, piece 0 or none above (x6_fwd_res)
    assert "X6_FWD_WIDE_MAX_D = 128;" in header and "const int keys = D <= X6_FWD_WIDE_MAX_D ? 128 : 64;" in header
    assert "launch_x6_fwd_tiles<128, X6_FWD_WIDE_MAX_D / 64, 3>" in header
    for res in (3, 1, 0):
        assert f"launch_x6_fwd_tiles<64, X6_MAX_D / 64, {res}>" in header, res
