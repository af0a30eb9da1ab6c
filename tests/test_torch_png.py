"""The port's PNG decoder (csrc/host/slamio.cpp through utils/native.py)
against the libpng build of the original runtime (native/src/slamio.cpp,
built by the port's build into its own directory under build/native/, never
native/build/): every colour type at each bit depth, plain and Adam7, the
colour chunks (gAMA, sRGB, cHRM, sBIT), a bad-CRC ancillary chunk, tRNS, a
palette index past PLTE and the files both refuse; chip_smoke.py's numpy
model of the RGB conversion; and its phase 8 (a2) tree of mixed PNG kinds
read back through the KITTI reader. Every case skips, with the reason, only
where the port's library cannot be built or loaded.
"""

import ctypes
import re
import struct
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

from stereo_visual_slam_tpu_torch.utils import native

REPO = Path(__file__).resolve().parents[1]
LIBPNG_SOURCES = (REPO / "native" / "src" / "slamio.cpp", REPO / "native" / "src" / "mapstore.cpp")
LIBPNG_LDLIBS = ("-lpng", "-lz", "-pthread")
# colour type, bit depth: every combination a PNG may have
KINDS = ((0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2), (3, 4),
         (3, 8), (4, 8), (4, 16), (6, 8), (6, 16))
COLOUR_NAMES = {0: "gray", 2: "rgb", 3: "palette", 4: "gray_alpha", 6: "rgba"}
# cHRM of primaries other than sRGB's (x 100000: white, red, green, blue)
WIDE_CHRM = (31270, 32900, 70800, 29200, 17000, 79700, 13100, 4600)


@pytest.fixture(autouse=True)
def _native_runtime():
    if not native.available():
        pytest.skip(f"native slamio library not available: {native.load_error()}")


def _chip_smoke():
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    return chip_smoke


@pytest.fixture(scope="module")
def libpng():
    """Decode with the libpng build of native/src/slamio.cpp: the image, or
    None where it fails (its probe decodes the whole image)."""
    lib = ctypes.CDLL(str(native.build(LIBPNG_SOURCES, LIBPNG_LDLIBS)))
    u8p, i32p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int)
    lib.sio_probe_image.argtypes = [ctypes.c_char_p, i32p, i32p]
    lib.sio_read_image_gray.argtypes = [ctypes.c_char_p, u8p, i32p, i32p, ctypes.c_int,
                                        ctypes.c_int]

    def read(path):
        h, w = ctypes.c_int(), ctypes.c_int()
        if lib.sio_probe_image(str(path).encode(), ctypes.byref(h), ctypes.byref(w)) != 0:
            return None
        out = np.empty((h.value, w.value), np.uint8)
        if lib.sio_read_image_gray(str(path).encode(), out.ctypes.data_as(u8p), ctypes.byref(h),
                                   ctypes.byref(w), h.value, w.value) != 0:
            return None
        return out

    return read


def _samples(seed, color, depth, h=13, w=19):
    """Random samples of a colour type and depth, a third of the RGB pixels
    gray; for a palette, a palette of 2^depth entries, a third of them gray."""
    rng = np.random.default_rng(seed)
    channels = _chip_smoke().PNG_CHANNELS[color]
    img = rng.integers(0, 1 << depth, size=(h, w, channels))
    img = img.astype(np.uint16 if depth == 16 else np.uint8)
    if color in (2, 6):
        gray = rng.random((h, w)) < 1 / 3
        img[gray, 1] = img[gray, 2] = img[gray, 0]
    palette = None
    if color == 3:
        palette = rng.integers(0, 256, size=(1 << depth, 3)).astype(np.uint8)
        palette[::3, 1] = palette[::3, 2] = palette[::3, 0]
    return (img[..., 0] if channels == 1 else img), palette


def _png(seed, color, depth, **chunks):
    img, palette = _samples(seed, color, depth)
    return _chip_smoke().png_bytes(img, first=seed % 5, color=color, depth=depth, palette=palette,
                                   **chunks)


def _chunk(tag, data):
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))


def _bad_crc(png, tag):
    """`png` with the CRC of its chunk `tag` broken."""
    at = png.index(tag)
    n = struct.unpack(">I", png[at - 4:at])[0]
    end = at + 4 + n
    return png[:end] + bytes([png[end] ^ 1]) + png[end + 1:]


def _with_sbit(png, bits):
    """`png` with an sBIT chunk of `bits` right after its header."""
    return png[:33] + _chunk(b"sBIT", bytes(bits)) + png[33:]


def _out_of_range_palette():
    """8-bit indices over all 256 values and a PLTE of 100 entries."""
    img = np.random.default_rng(3).integers(0, 256, size=(9, 31)).astype(np.uint8)
    palette = np.random.default_rng(4).integers(1, 256, size=(100, 3)).astype(np.uint8)
    return _chip_smoke().png_bytes(img, color=3, palette=palette)


def _parity_cases():
    """(id, PNG, the PNG libpng decodes for it, the PNG without the chunk
    under test or None): every kind plain and Adam7, then the chunks."""
    cases = []
    for seed, (color, depth) in enumerate(KINDS):
        for interlace in (0, 1):
            name = f"{COLOUR_NAMES[color]}{depth}" + ("-adam7" if interlace else "")
            png = _png(seed, color, depth, interlace=interlace)
            cases.append((name, png, png, None))
    # tRNS: its alpha is stripped. libpng's runtime writes a gray+alpha row
    # into a gray row there (png_set_strip_alpha is called only for the
    # colour types with alpha), so the oracle is the same file without it.
    for color, depth, trns in ((0, 8, (7,)), (2, 16, (1, 2, 3)), (3, 4, (0, 128, 255))):
        plain = _png(40 + color, color, depth)
        cases.append((f"{COLOUR_NAMES[color]}{depth}-tRNS",
                      _png(40 + color, color, depth, trns=trns), plain, None))
    for color, depth in ((2, 8), (2, 16), (3, 8), (6, 8), (6, 16)):
        name = f"{COLOUR_NAMES[color]}{depth}"
        plain = _png(50 + color, color, depth)
        for label, chunks in (("gAMA", dict(gamma=45455)), ("sRGB", dict(srgb=0)),
                              ("cHRM", dict(chrm=WIDE_CHRM))):
            png = _png(50 + color, color, depth, **chunks)
            cases.append((f"{name}-{label}", png, png, plain))
    for label, chunks in (("gAMA-sRGB", dict(gamma=45455, srgb=1)),
                          ("gAMA-cHRM", dict(gamma=55555, chrm=WIDE_CHRM)),
                          ("gAMA-0.95", dict(gamma=95000))):
        png = _png(60, 2, 16, **chunks)
        cases.append((f"rgb16-{label}", png, png, _png(60, 2, 16)))
    gamma = _png(62, 2, 16, gamma=45455)   # sBIT under 11 bits narrows the 16-bit tables
    for bits in ((8, 8, 8), (4, 9, 6)):
        png = _with_sbit(gamma, bits)
        cases.append((f"rgb16-gAMA-sBIT{max(bits)}", png, png, gamma))
    bad = _bad_crc(_png(61, 2, 8, gamma=45455), b"gAMA")
    cases.append(("rgb8-gAMA-bad-CRC", bad, bad, None))
    past = _out_of_range_palette()
    cases.append(("palette-index-past-PLTE", past, past, None))
    return cases


PARITY = _parity_cases()


@pytest.mark.parametrize("png, oracle, plain", [c[1:] for c in PARITY],
                         ids=[c[0] for c in PARITY])
def test_decoder_matches_libpng(tmp_path, libpng, png, oracle, plain):
    """The port decodes byte-equal to libpng and probes the same size. A
    colour chunk case also shows that the chunk moves libpng's output."""
    p, ref = tmp_path / "x.png", tmp_path / "oracle.png"
    p.write_bytes(png)
    ref.write_bytes(oracle)
    expect = libpng(ref)
    assert expect is not None
    got = native.read_image_gray(str(p))
    np.testing.assert_array_equal(got, expect)
    assert native.probe_image(str(p)) == expect.shape
    if plain is not None:
        ref.write_bytes(plain)
        assert not np.array_equal(libpng(ref), expect)


def test_bad_crc_ancillary_chunk_is_dropped(tmp_path, libpng):
    """A gAMA with a bad CRC decodes as if it were absent, in both."""
    p = tmp_path / "x.png"
    outs = []
    for png in (_bad_crc(_png(61, 2, 8, gamma=45455), b"gAMA"), _png(61, 2, 8)):
        p.write_bytes(png)
        outs += [native.read_image_gray(str(p)), libpng(p)]
    for out in outs[1:]:
        np.testing.assert_array_equal(out, outs[0])


def _raw_png(color=0, depth=8, w=5, h=3, compression=0, filter_method=0, interlace=0,
             before=b"", idat=True):
    """A PNG whose IHDR says what it is given, with `before` ahead of one
    IDAT (`idat=False`: none) that no refused file gets as far as reading."""
    chunks = _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, compression,
                                         filter_method, interlace)) + before
    if idat:
        chunks += _chunk(b"IDAT", zlib.compress(bytes(64)))
    return b"\x89PNG\r\n\x1a\n" + chunks + _chunk(b"IEND", b"")


PLTE = _chunk(b"PLTE", bytes(range(48)))


@pytest.mark.parametrize("png, reason", [
    (_raw_png(color=2, depth=4), "bad PNG bit depth 4 for colour type 2 (RGB)"),
    (_raw_png(color=4, depth=2), "bad PNG bit depth 2 for colour type 4 (gray+alpha)"),
    (_raw_png(color=6, depth=1), "bad PNG bit depth 1 for colour type 6 (RGBA)"),
    (_raw_png(color=3, depth=16, before=PLTE), "bad PNG bit depth 16 for colour type 3"),
    (_raw_png(depth=3), "bad PNG bit depth 3"),
    (_raw_png(color=5), "bad PNG colour type 5"),
    (_raw_png(interlace=2), "bad PNG interlace method 2"),
    (_raw_png(compression=1), "bad PNG compression method 1"),
    (_raw_png(filter_method=64), "bad PNG filter method 64"),
    (_raw_png(w=0), "bad PNG size 0x3"),
    (_raw_png(color=3), "palette image without a PLTE chunk"),
    (_raw_png(color=3, before=_chunk(b"PLTE", bytes(20))), "bad PNG palette of 20 bytes"),
    (_raw_png(color=2, before=_chunk(b"PLTE", b"")), "bad PNG palette of 0 bytes"),
    (_raw_png(color=3, before=PLTE + PLTE), "two PLTE chunks"),
    (_raw_png(idat=False), "PNG without image data"),
], ids=["rgb4", "gray_alpha2", "rgba1", "palette16", "depth3", "colour5", "interlace2",
        "compression1", "filter64", "width0", "palette-no-PLTE", "PLTE-bad-length",
        "PLTE-empty", "two-PLTE", "no-IDAT"])
def test_decoder_refuses_what_libpng_refuses(tmp_path, libpng, png, reason):
    """Both decoders fail, and the port's IOError names the fault; a fault
    of the header alone fails the port's probe already."""
    p = tmp_path / "x.png"
    p.write_bytes(png)
    assert libpng(p) is None
    with pytest.raises(IOError, match=re.escape(reason)):
        native.read_image_gray(str(p))
    if reason.startswith("bad PNG") and "palette" not in reason:
        with pytest.raises(IOError, match=re.escape(reason)):
            native.probe_image(str(p))


@pytest.mark.parametrize("dtype", (np.uint8, np.uint16), ids=("rgb8", "rgb16"))
def test_rgb_model_matches_libpng(tmp_path, libpng, dtype):
    """chip_smoke.gray_of_rgb, phase 8 (e)'s oracle on the card's machine
    (which has no libpng), gives libpng's bytes, and so does the port."""
    smoke = _chip_smoke()
    rng = np.random.default_rng(9)
    rgb = rng.integers(0, np.iinfo(dtype).max + 1, size=(41, 57, 3)).astype(dtype)
    rgb[::4, :, 1] = rgb[::4, :, 2] = rgb[::4, :, 0]   # gray rows, too
    p = tmp_path / "x.png"
    p.write_bytes(smoke.png_bytes(rgb, color=2))
    model = smoke.gray_of_rgb(rgb)
    np.testing.assert_array_equal(libpng(p), model)
    np.testing.assert_array_equal(native.read_image_gray(str(p)), model)


@pytest.mark.parametrize("kinds", [(k,) for k in ("rgb", "rgba", "palette", "adam7",
                                                   "gray_alpha", "gray16")] + [None],
                         ids=["rgb", "rgba", "palette", "adam7", "gray_alpha", "gray16",
                              "mixed"])
def test_phase8_mixed_tree_reads_back(tmp_path, libpng, kinds):
    """Phase 8 (a2) at small_config's size: frames written in one kind (or
    in chip_smoke.MIXED_KINDS, left and right apart) come back through the
    KITTI reader and the prefetcher byte-equal, and libpng reads the same."""
    from stereo_visual_slam_tpu_torch.data import kitti, synthetic
    from stereo_visual_slam_tpu_torch.utils.config import small_config

    smoke = _chip_smoke()
    kinds = kinds or smoke.MIXED_KINDS
    cfg = small_config()
    world = synthetic.make_world(cfg, n_frames=3, n_points=400, seed=4)
    frames = list(synthetic.frames(world))
    smoke.write_kitti(str(tmp_path), frames, world, cfg.camera, kinds=kinds)
    seq = kitti.open_sequence(str(tmp_path), "00")
    assert seq.n_frames == len(frames)
    smoke.check_decoded(seq, frames, "mixed tree")
    left = seq.seq_dir + "/image_0/000001.png"
    colour = Path(left).read_bytes()[25]
    assert colour == {"rgb": 2, "rgba": 6, "palette": 3, "adam7": 0, "gray_alpha": 4,
                      "gray16": 0}[kinds[1 % len(kinds)]]
    np.testing.assert_array_equal(libpng(left), frames[1][1].astype(np.uint8))
