"""The port's KITTI I/O (``velo_tpu_torch/io/kitti.py``, ``png.py``,
``fake_kitti.py``) against the reference's (``velo_tpu/io/kitti.py``,
``scripts/make_fake_kitti.py``) on exported sequence directories.

Everything here is exact: bytes, arrays and decoded pixels are equal, not
close.  OpenCV appears only as the yardstick of the PNG codec.
"""
import importlib.util
import os
import struct
import zlib

import numpy as np
import pytest

from velo_tpu.io import kitti as jkitti
from velo_tpu_torch.io import fake_kitti, png
from velo_tpu_torch.io import kitti as tkitti

try:
    import cv2
except ImportError:  # the yardstick is missing: those comparisons skip
    cv2 = None
needs_cv2 = pytest.mark.skipif(cv2 is None, reason="compares with OpenCV")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPORT = dict(frames=3, rings=16, azimuth=256, height=48, width=160, seed=4)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    out = tmp_path_factory.mktemp("port_export")
    fake_kitti.export(str(out), **EXPORT)
    return out


@pytest.fixture(scope="module")
def reference_root(tmp_path_factory):
    """The same arguments through ``scripts/make_fake_kitti.py``."""
    spec = importlib.util.spec_from_file_location(
        "make_fake_kitti", os.path.join(REPO, "scripts", "make_fake_kitti.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = tmp_path_factory.mktemp("reference_export")
    argv = ["--out", str(out)]
    for key, value in EXPORT.items():
        argv += [f"--{key}", str(value)]
    mod.main(argv)
    return out


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@needs_cv2
def test_export_equals_the_reference_script(root, reference_root):
    """File by file: scans, calib, times and poses byte for byte, images
    pixel for pixel after decoding (the two PNG encoders compress
    differently)."""
    names = _files(root)
    assert names == _files(reference_root) and len(names) == 3 + 3 + 3
    for name in names:
        a, b = root / name, reference_root / name
        if name.endswith(".png"):
            np.testing.assert_array_equal(
                png.read_gray8(str(a)),
                cv2.imread(str(b), cv2.IMREAD_GRAYSCALE))
        else:
            assert a.read_bytes() == b.read_bytes(), name


@needs_cv2
def test_readers_equal_the_reference(root):
    seq = root / "sequences" / "00"
    for i in range(EXPORT["frames"]):
        path = str(seq / "velodyne" / f"{i:06d}.bin")
        a, b = tkitti.read_velodyne_bin(path), jkitti.read_velodyne_bin(path)
        assert a.dtype == np.float32 and a.shape[1] == 4
        np.testing.assert_array_equal(a, b)
        assert a.tobytes() == open(path, "rb").read()
        img = str(seq / "image_0" / f"{i:06d}.png")
        ta, jb = tkitti.read_image_gray(img), jkitti.read_image_gray(img)
        assert ta.dtype == jb.dtype == np.float32
        assert ta.shape == (EXPORT["height"], EXPORT["width"])
        np.testing.assert_array_equal(ta, jb)
    ca = tkitti.read_calib(str(seq / "calib.txt"))
    cb = jkitti.read_calib(str(seq / "calib.txt"))
    assert sorted(ca) == sorted(cb) == ["P0", "P1", "P2", "P3", "Tr"]
    for key in ca:
        np.testing.assert_array_equal(ca[key], cb[key])
    assert ca["Tr"].shape == (4, 4) and ca["P0"].shape == (3, 4)
    np.testing.assert_array_equal(tkitti.read_times(str(seq / "times.txt")),
                                  jkitti.read_times(str(seq / "times.txt")))


def test_poses_round_trip(root, tmp_path):
    gt = str(root / "poses" / "00.txt")
    a, b = tkitti.read_poses(gt), jkitti.read_poses(gt)
    assert a.shape == (EXPORT["frames"], 4, 4)
    np.testing.assert_array_equal(a, b)
    tkitti.write_poses(str(tmp_path / "t" / "p.txt"), a)
    jkitti.write_poses(str(tmp_path / "j" / "p.txt"), a)
    text = (tmp_path / "t" / "p.txt").read_bytes()
    assert text == (tmp_path / "j" / "p.txt").read_bytes()
    assert text == open(gt, "rb").read()  # "%.9e" survives the round trip
    assert all(len(line.split()) == 12 for line in text.decode().splitlines())


@pytest.mark.parametrize("n_max", [100, 5000])
def test_pad_scan_equals_the_reference(root, n_max):
    scan = tkitti.read_velodyne_bin(
        str(root / "sequences" / "00" / "velodyne" / "000000.bin"))
    assert 100 < len(scan) < 5000
    (a, am), (b, bm) = tkitti.pad_scan(scan, n_max), jkitti.pad_scan(scan,
                                                                      n_max)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(am, bm)
    assert a.shape == (n_max, 4) and am.sum() == min(len(scan), n_max)
    assert (a[~am] == np.float32(1e6)).all()


@needs_cv2
def test_sequence_and_prefetcher_equal_the_reference(root):
    ts = tkitti.KittiSequence(str(root), "00", n_max_points=4096)
    js = jkitti.KittiSequence(str(root), "00", n_max_points=4096)
    assert ts.n_frames == js.n_frames == EXPORT["frames"]
    np.testing.assert_array_equal(ts.gt_poses, js.gt_poses)
    np.testing.assert_array_equal(ts.times, js.times)
    for i in range(ts.n_frames):
        for x, y in zip(ts.scan(i), js.scan(i)):
            np.testing.assert_array_equal(x, y)
    # Read-ahead returns the frames in the order asked for, also out of
    # sequence, and each exactly once per request.
    order = [0, 1, 2, 1, 0]
    tp, jp = (k.ImagePrefetcher(s.image, s.n_frames, depth=2)
              for k, s in ((tkitti, ts), (jkitti, js)))
    try:
        for i in order:
            a = tp.get(i)
            np.testing.assert_array_equal(a, jp.get(i))
            np.testing.assert_array_equal(a, ts.image(i))
    finally:
        tp.close()
        jp.close()
    missing = tkitti.KittiSequence(str(root), "00")
    assert missing.n_max_points == 131072


def _images():
    rng = np.random.default_rng(5)
    smooth = np.add.outer(np.arange(37), 2 * np.arange(53)).astype(np.uint8)
    return {"noise": rng.integers(0, 256, (48, 160), dtype=np.uint8),
            "ramp": smooth,  # wraps mod 256: every filter type pays off
            "flat": np.full((5, 7), 200, np.uint8),
            "one_pixel": np.array([[17]], np.uint8)}


@needs_cv2
@pytest.mark.parametrize("name", ["noise", "ramp", "flat", "one_pixel"])
def test_png_codec_against_opencv(tmp_path, name):
    img = _images()[name]
    ours, theirs = str(tmp_path / "ours.png"), str(tmp_path / "theirs.png")
    png.write_gray8(ours, img)
    assert cv2.imwrite(theirs, img)
    for path in (ours, theirs):
        got = png.read_gray8(path)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, img)
        np.testing.assert_array_equal(
            cv2.imread(path, cv2.IMREAD_UNCHANGED), img)


def _png_with_filter(img, ftype):
    """``img`` encoded with one scanline filter type throughout."""
    h, w = img.shape
    x = img.astype(np.int64)
    left = np.pad(x, ((0, 0), (1, 0)))[:, :-1]
    up = np.pad(x, ((1, 0), (0, 0)))[:-1]
    upleft = np.pad(x, ((1, 0), (1, 0)))[:-1, :-1]
    if ftype == 0:
        pred = np.zeros_like(x)
    elif ftype == 1:
        pred = left
    elif ftype == 2:
        pred = up
    elif ftype == 3:
        pred = (left + up) // 2
    else:
        p = left + up - upleft
        pa, pb, pc = abs(p - left), abs(p - up), abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left,
                        np.where(pb <= pc, up, upleft))
    raw = np.concatenate([np.full((h, 1), ftype, np.uint8),
                          ((x - pred) % 256).astype(np.uint8)], axis=1)
    return (png._SIGNATURE
            + png._chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + png._chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + png._chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_png_reads_each_scanline_filter(tmp_path, ftype):
    img = _images()["noise"]
    path = tmp_path / "f.png"
    path.write_bytes(_png_with_filter(img, ftype))
    np.testing.assert_array_equal(png.read_gray8(str(path)), img)
    if cv2 is not None:  # the hand-made file is a PNG to others too
        np.testing.assert_array_equal(
            cv2.imread(str(path), cv2.IMREAD_UNCHANGED), img)


def _header_variant(depth=8, colour=0, interlace=0):
    body = zlib.compress(b"\0" * 64)
    return (png._SIGNATURE
            + png._chunk(b"IHDR", struct.pack(">IIBBBBB", 4, 4, depth, colour,
                                              0, 0, interlace))
            + png._chunk(b"IDAT", body) + png._chunk(b"IEND", b""))


@pytest.mark.parametrize("kw, word", [
    (dict(colour=2), "colour"), (dict(colour=6), "colour"),
    (dict(colour=3), "palette"), (dict(colour=4), "alpha"),
    (dict(depth=16), "16-bit"), (dict(interlace=1), "interlaced"),
])
def test_png_refuses_other_formats_by_name(tmp_path, kw, word):
    path = tmp_path / "x.png"
    path.write_bytes(_header_variant(**kw))
    with pytest.raises(ValueError, match=word):
        png.read_gray8(str(path))


@needs_cv2
def test_png_refuses_files_opencv_wrote_in_other_formats(tmp_path):
    rng = np.random.default_rng(6)
    colour = str(tmp_path / "c.png")
    deep = str(tmp_path / "d.png")
    assert cv2.imwrite(colour, rng.integers(0, 256, (8, 9, 3), dtype=np.uint8))
    assert cv2.imwrite(deep, rng.integers(0, 65536, (8, 9), dtype=np.uint16))
    with pytest.raises(ValueError, match="colour"):
        png.read_gray8(colour)
    with pytest.raises(ValueError, match="16-bit"):
        png.read_gray8(deep)


def test_png_checks_crcs_and_structure(tmp_path):
    good = tmp_path / "g.png"
    png.write_gray8(str(good), _images()["flat"])
    data = bytearray(good.read_bytes())
    data[-20] ^= 1  # inside the IDAT payload
    bad = tmp_path / "b.png"
    bad.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        png.read_gray8(str(bad))
    bad.write_bytes(good.read_bytes()[:-12])  # no IEND
    with pytest.raises(ValueError, match="IEND|truncated"):
        png.read_gray8(str(bad))
    bad.write_bytes(b"not a png at all")
    with pytest.raises(ValueError, match="not a PNG"):
        png.read_gray8(str(bad))
    with pytest.raises(ValueError, match="uint8"):
        png.write_gray8(str(bad), np.zeros((4, 4), np.float32))


def test_fake_kitti_command_line(tmp_path, capsys):
    assert fake_kitti.main(["--out", str(tmp_path), "--frames", "1", "--rings",
                            "16", "--azimuth", "256", "--height", "48",
                            "--width", "160"]) == 0
    assert "wrote 1 frames" in capsys.readouterr().out
    assert len(_files(tmp_path)) == 1 + 1 + 3
