"""The port's native I/O: the C++ scan loader (``io/native_loader.py``
over ``native/veloio.cpp``) and the C++ PNG unfilter behind
``io/png.read_gray8``.

The loader's tests mirror the reference's ``tests/unit/test_native_loader.py``
(padded scans equal to the Python reader, truncation, a missing directory,
binned grids against ``bin_scan_host``), on a ``fake_kitti`` export.  The
unfilter is held byte for byte against the Python loop it replaced
(``png._unfilter_reference``) for each of the five filter types and for
mixed rows.
"""
import ctypes
import os
import threading
import time

import numpy as np
import pytest
import torch

from velo_tpu.lidar import rangeimage as jri
from velo_tpu_torch import cli as tcli
from velo_tpu_torch import config as tconfig
from velo_tpu_torch.io import fake_kitti, kitti, native_loader, png
from velo_tpu_torch.lidar import rangeimage as tri

torch.set_num_threads(1)

RINGS, AZ = 16, 512


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti")
    fake_kitti.export(str(root), frames=3, rings=RINGS, azimuth=AZ,
                      height=64, width=192, seed=4)
    return root


@pytest.fixture(scope="module")
def velo_dir(kitti_root):
    return str(kitti_root / "sequences" / "00" / "velodyne")


def _scan(velo_dir, i):
    return kitti.read_velodyne_bin(os.path.join(velo_dir, f"{i:06d}.bin"))


def test_matches_python_reader(velo_dir):
    n_max = RINGS * AZ
    loader = native_loader.NativeScanLoader(velo_dir, n_max=n_max)
    assert len(loader) == 3
    got = list(loader)
    loader.close()
    assert len(got) == 3
    for i, (pts, mask) in enumerate(got):
        ref, ref_mask = kitti.pad_scan(_scan(velo_dir, i), n_max)
        np.testing.assert_array_equal(pts, ref)
        np.testing.assert_array_equal(mask, ref_mask)


def test_truncates_oversized(velo_dir):
    loader = native_loader.NativeScanLoader(velo_dir, n_max=600)
    for i, (pts, mask) in enumerate(loader):
        assert mask.sum() == min(600, _scan(velo_dir, i).shape[0])
        np.testing.assert_array_equal(pts[:600], _scan(velo_dir, i)[:600])


def test_missing_dir(tmp_path):
    with pytest.raises(FileNotFoundError):
        native_loader.NativeScanLoader(str(tmp_path / "none"), n_max=128)
    with pytest.raises(FileNotFoundError):
        native_loader.NativeBinnedScanLoader(
            str(tmp_path), tconfig.LidarConfig(n_rings=RINGS, n_azimuth=AZ))


@pytest.mark.parametrize("mode", ["uniform", "hdl64e"])
def test_binned_loader_matches_bin_scan_host(velo_dir, mode):
    """Valid masks equal, grids within the reference's own 1e-6, against
    the port's ``bin_scan_host`` and the reference's (equal to each
    other bit for bit)."""
    cfg = tconfig.LidarConfig(n_rings=RINGS, n_azimuth=AZ, ring_mode=mode,
                              az_start=float(np.pi))
    loader = native_loader.NativeBinnedScanLoader(velo_dir, cfg,
                                                  n_max=RINGS * AZ)
    bitwise = []
    for i, (grid, valid) in enumerate(loader):
        scan = _scan(velo_dir, i)
        ref_grid, ref_valid = tri.bin_scan_host(scan, cfg)
        j_grid, j_valid = jri.bin_scan_host(scan, cfg)
        np.testing.assert_array_equal(ref_grid, j_grid)
        np.testing.assert_array_equal(ref_valid, j_valid)
        assert valid.any()
        np.testing.assert_array_equal(valid, ref_valid)
        np.testing.assert_allclose(grid, ref_grid, atol=1e-6)
        bitwise.append(bool(np.array_equal(grid, ref_grid)))
    loader.close()
    assert len(bitwise) == 3
    print(f"{mode}: grids bitwise equal to bin_scan_host: {bitwise}")


def test_library_rebuilds_when_a_source_changes(monkeypatch, tmp_path):
    """The library's name hashes both sources; without g++ the build
    raises an error that names it, and ``read_gray8`` passes it on."""
    path = native_loader.library_path()
    assert path.parent == native_loader.BUILD_DIR and path.exists()
    srcs = []
    for src in native_loader.SOURCES:
        copy = tmp_path / src.name
        copy.write_bytes(src.read_bytes() + b"\n// edited\n")
        srcs.append(copy)
    monkeypatch.setattr(native_loader, "SOURCES", tuple(srcs))
    assert native_loader.library_path() != path
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native_loader.load_library()
    img = np.arange(24, dtype=np.uint8).reshape(4, 6)
    png.write_gray8(str(tmp_path / "x.png"), img)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        png.read_gray8(str(tmp_path / "x.png"))


def _image(rng, h=37, w=53):
    # Smooth content plus noise, so that every predictor is exercised.
    yy, xx = np.mgrid[0:h, 0:w]
    base = 128 + 60 * np.sin(xx / 7.0) * np.cos(yy / 5.0)
    return np.clip(base + rng.normal(0, 25, (h, w)), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4],
                         ids=["none", "sub", "up", "average", "paeth"])
def test_unfilter_equals_python_loop(ftype):
    rng = np.random.default_rng(10 + ftype)
    img = _image(rng)
    h, w = img.shape
    raw = png._filter_rows(img, np.full(h, ftype))
    native = png._unfilter(raw, h, w, "x.png")
    np.testing.assert_array_equal(native, png._unfilter_reference(
        raw, h, w, "x.png"))
    np.testing.assert_array_equal(native, img)
    # Arbitrary filtered bytes too (not only what an encoder writes).
    junk = rng.integers(0, 256, (h, w + 1)).astype(np.uint8)
    junk[:, 0] = ftype
    np.testing.assert_array_equal(png._unfilter(junk, h, w, "x.png"),
                                  png._unfilter_reference(junk, h, w,
                                                          "x.png"))


def test_mixed_filters_through_read_gray8(tmp_path):
    rng = np.random.default_rng(7)
    img = _image(rng, 61, 97)
    filters = rng.integers(0, 5, img.shape[0])
    path = str(tmp_path / "mixed.png")
    png.write_gray8(path, img, filters=filters)
    np.testing.assert_array_equal(png.read_gray8(path), img)
    raw = png._filter_rows(img, filters)
    np.testing.assert_array_equal(
        png._unfilter(raw, *img.shape, path),
        png._unfilter_reference(raw, *img.shape, path))
    bad = raw.copy()
    bad[5, 0] = 7
    with pytest.raises(ValueError, match="filter type 7"):
        png._unfilter(bad, *img.shape, path)


def test_unfilter_releases_the_gil():
    """While one thread unfilters a large Paeth image, another thread keeps
    running Python: it is never held up for the whole decode."""
    rng = np.random.default_rng(3)
    img = _image(rng, 2000, 2000)
    raw = png._filter_rows(img, np.full(2000, 4))
    lib = native_loader.load_library()
    out = np.empty_like(img)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    t0 = time.perf_counter()
    lib.velo_png_unfilter(raw.ctypes.data_as(u8), 2000, 2000,
                          out.ctypes.data_as(u8))
    decode_s = time.perf_counter() - t0
    ticks, stop = [], threading.Event()

    def tick():
        while not stop.is_set():
            ticks.append(time.perf_counter())
            time.sleep(0.0005)

    th = threading.Thread(target=tick)
    th.start()
    time.sleep(0.01)
    t0 = time.perf_counter()
    for _ in range(5):
        png._unfilter(raw, 2000, 2000, "x.png")
    t1 = time.perf_counter()
    stop.set()
    th.join(timeout=10)
    assert not th.is_alive()
    inside = [t for t in ticks if t0 <= t <= t1]
    print(f"decode {1e3 * decode_s:.2f} ms, {len(inside)} ticks during "
          f"{1e3 * (t1 - t0):.2f} ms of decodes")
    assert len(inside) >= 2


@pytest.mark.parametrize("flags, reader", [
    (["--no-vision"], "native-binned"),
    (["--no-vision", "--no-prebin"], "native"),
])
def test_cli_names_the_scan_reader(tmp_path, capsys, kitti_root, monkeypatch,
                                   flags, reader):
    """The KITTI path reads scans with the native loader, says which on
    stderr, and falls back to the Python reader (same poses) when the
    library cannot be built."""
    argv = ["--kitti-root", str(kitti_root), "--frames", "2", "--set",
            f"l:n_rings={RINGS}+n_azimuth={AZ}+n_sectors=8,"
            "m:edge_capacity=4096+planar_capacity=8192", "--device", "cpu"]
    assert tcli.main(argv + flags + ["--out", str(tmp_path / "a")]) == 0
    assert f"scan reader: {reader}\n" in capsys.readouterr().err

    def no_gxx():
        raise RuntimeError("native loader unavailable: g++ not found")

    monkeypatch.setattr(native_loader, "load_library", no_gxx)
    assert tcli.main(argv + flags + ["--out", str(tmp_path / "b")]) == 0
    assert "scan reader: python\n" in capsys.readouterr().err
    a = kitti.read_poses(str(tmp_path / "a" / "00.txt"))
    b = kitti.read_poses(str(tmp_path / "b" / "00.txt"))
    assert a.shape == (2, 4, 4)
    np.testing.assert_allclose(a, b, atol=1e-6)
