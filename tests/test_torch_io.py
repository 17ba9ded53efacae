"""The port's host runtime against ``txr``'s on the same arrays: the native
library (``txr_torch._native`` against ``txr._native``), the PLY / PCD /
16-bit PNG / npy writers (byte-identical files), the readers, the frame
sources, the RTAB-Map replay, the ROS2 packers and the configurations.

Where a path has a fallback, both are covered: the native library is turned
off by making ``get_lib`` return None (on both sides), OpenCV by putting
None into ``sys.modules["cv2"]`` (the port imports it at first use) and by
setting ``txr``'s module attributes as ``tests/test_depth_pipeline.py``
does.
"""

import contextlib
import dataclasses
import json
import os
import sqlite3
import subprocess
import sys

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import txr._native as tnat
import txr.io.depth_io as tdio
import txr.io.ply as tply
import txr.io.rtabmap_db as trdb
import txr.io.sources as tsrc
import txr.ros2.publisher as tpub
from txr.core.config import ReconstructionConfig as TRecon
from txr.core.config import StreamingConfig as TStream
from txr.core.types import PointSet as TPointSet

import txr_torch._native as pnat
import txr_torch.io as pio
import txr_torch.io.depth_io as pdio
import txr_torch.io.ply as pply
import txr_torch.io.rtabmap_db as prdb
import txr_torch.io.sources as psrc
import txr_torch.ros2.publisher as ppub
from txr_torch.core import ReconstructionConfig, StreamingConfig
from txr_torch.core.types import PointSet

sys.path.insert(0, os.path.dirname(__file__))
from test_rtabmap_db import make_calib_blob, rtabmap_db  # noqa: E402,F401

torch.set_num_threads(1)


@contextlib.contextmanager
def private_txr_native(tmp_dir):
    """Point ``txr._native`` at a copy of its library that this worker built
    alone, and restore its module state afterwards.

    ``txr``'s loader (``txr/_native/__init__.py:44-58``) compiles in place,
    straight to the final ``.so`` with no temporary name, and gives up for
    the rest of the process when that file does not load. A fresh tree has
    no library, so when several test workers reach it at once one of them
    can load a half-written file and see ``txr``'s side as None. Here the
    same source is compiled with the same four link variants under a
    temporary name and renamed into place, as the port's own loader does;
    ``txr/`` itself is left as it is."""
    path = os.path.join(str(tmp_dir), "libtxr_native.so")
    tmp = f"{path}.{os.getpid()}.tmp"
    base = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", tmp,
            tnat._SRC]
    jpeg, png = ["-DTXR_HAVE_JPEG", "-ljpeg"], ["-DTXR_HAVE_PNG", "-lpng"]
    for flags in (jpeg + png, jpeg, png, []):
        try:
            subprocess.run(base + flags, check=True, capture_output=True,
                           timeout=120)
        except (subprocess.CalledProcessError, FileNotFoundError,
                subprocess.TimeoutExpired):
            continue
        os.replace(tmp, path)
        break
    saved = tnat._LIB, tnat._lib, tnat._tried
    tnat._LIB, tnat._lib, tnat._tried = path, None, False
    try:
        yield
    finally:
        tnat._LIB, tnat._lib, tnat._tried = saved


@pytest.fixture(scope="module", autouse=True)
def txr_native_of_this_worker(tmp_path_factory):
    """``txr``'s native library, built for this module alone (see
    ``private_txr_native``: ``txr``'s in-place build races other
    workers)."""
    with private_txr_native(tmp_path_factory.mktemp("txr_native")):
        yield


@pytest.fixture()
def native_off(monkeypatch):
    """Both packages without their native library."""
    monkeypatch.setattr(pnat, "get_lib", lambda: None)
    monkeypatch.setattr(tnat, "get_lib", lambda: None)


@pytest.fixture()
def cv2_off(monkeypatch):
    """Both packages without OpenCV."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setattr(tsrc, "cv2", None, raising=False)
    monkeypatch.setattr(tsrc, "CV2_AVAILABLE", False)
    monkeypatch.setattr(tdio, "CV2_AVAILABLE", False)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _cloud(rng, n=257):
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    rgb = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    # values on the rounding tie of the colour quantisation, and out of range
    rgb[:4, 0] = [0.5 / 255, 254.5 / 255, -0.1, 1.2]
    return xyz, rgb


# --------------------------------------------------------------- native


class TestNativeLibrary:
    def test_builds_under_its_own_name_with_txr_codecs(self):
        lib = pnat.get_lib()
        if lib is None or tnat.get_lib() is None:
            pytest.skip("no C++ toolchain")
        assert os.path.basename(pnat.lib_path()) == "libtxr_torch_native.so"
        assert pnat.lib_path() != tnat._LIB
        want = tnat.get_lib()
        assert pnat.codecs() == {"jpeg": bool(want.txr_has_jpeg()),
                                 "png": bool(want.txr_has_png())}

    def test_build_is_atomic_and_leaves_no_temporary(self, tmp_path):
        if pnat.get_lib() is None:
            pytest.skip("no C++ toolchain")
        target = tmp_path / "libtxr_torch_native.so"
        assert pnat._build(str(target))
        assert [p.name for p in tmp_path.iterdir()] == [target.name]

    def test_a_library_that_does_not_load_is_built_again(self, tmp_path,
                                                         monkeypatch):
        """A library newer than its source that this machine cannot load
        (built elsewhere, against other codec libraries) is rebuilt."""
        if pnat.get_lib() is None:
            pytest.skip("no C++ toolchain")
        target = tmp_path / "libtxr_torch_native.so"
        target.write_bytes(b"not a shared object")
        monkeypatch.setattr(pnat, "lib_path", lambda: str(target))
        monkeypatch.setattr(pnat, "_lib", None)
        monkeypatch.setattr(pnat, "_tried", False)
        lib = pnat.get_lib()
        assert lib is not None and lib.txr_has_jpeg() in (0, 1)
        assert target.read_bytes()[:4] == b"\x7fELF"

    @pytest.mark.parametrize("with_rgb", [True, False])
    def test_compact(self, rng, with_rgb):
        xyz, rgb = _cloud(rng, 100)
        mask = rng.random(100) > 0.4
        got = pnat.native_compact(xyz, rgb if with_rgb else None, mask)
        want = tnat.native_compact(xyz, rgb if with_rgb else None, mask)
        if got is None or want is None:
            pytest.skip("no C++ toolchain")
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[0], xyz[mask])
        if with_rgb:
            np.testing.assert_array_equal(got[1], want[1])
        else:
            assert got[1] is None and want[1] is None

    @pytest.mark.parametrize("with_rgb", [True, False])
    def test_pack_xyzrgb(self, rng, with_rgb):
        xyz, rgb = _cloud(rng, 100)
        got = pnat.native_pack_xyzrgb(xyz, rgb if with_rgb else None)
        want = tnat.native_pack_xyzrgb(xyz, rgb if with_rgb else None)
        if got is None or want is None:
            pytest.skip("no C++ toolchain")
        assert got == want

    def test_jpeg_decode(self, rng, tmp_path):
        img = rng.integers(0, 255, (37, 53, 3), dtype=np.uint8)
        ok, enc = cv2.imencode(".jpg", img)
        got = pnat.native_decode_jpeg(enc.tobytes())
        if got is None:
            pytest.skip("no native JPEG decoder")
        np.testing.assert_array_equal(got, tnat.native_decode_jpeg(
            enc.tobytes()))
        np.testing.assert_array_equal(got, cv2.imdecode(enc,
                                                        cv2.IMREAD_COLOR))
        assert pnat.native_decode_jpeg(b"not a jpeg") is None

    def test_png16_codec(self, rng):
        img = rng.integers(0, 65535, (31, 45), dtype=np.uint16)
        data = pnat.native_encode_png16(img)
        if data is None:
            pytest.skip("no native PNG codec")
        assert data == tnat.native_encode_png16(img)
        np.testing.assert_array_equal(pnat.native_decode_png16(data), img)
        ok, enc = cv2.imencode(".png", img)
        np.testing.assert_array_equal(pnat.native_decode_png16(enc.tobytes()),
                                      img)

    @pytest.mark.parametrize("native", [True, False])
    def test_pointset_to_numpy(self, rng, native, monkeypatch):
        if not native:
            monkeypatch.setattr(pnat, "get_lib", lambda: None)
        xyz, rgb = _cloud(rng, 64)
        mask = rng.random(64) > 0.5
        got = PointSet(torch.from_numpy(xyz), torch.from_numpy(rgb),
                       torch.from_numpy(mask)).to_numpy()
        want = TPointSet(xyz, rgb, mask).to_numpy()
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))


# -------------------------------------------------------------- writers


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("colour", ["none", "float", "uint8", "float255"])
@pytest.mark.parametrize("fmt", ["binary", "ascii", "binary_double"])
def test_write_ply_bytes_equal_txr(rng, tmp_path, request, fmt, colour,
                                   native):
    if not native:
        request.getfixturevalue("native_off")
    xyz, rgb = _cloud(rng)
    c = {"none": None, "float": rgb,
         "uint8": (rgb.clip(0, 1) * 255).astype(np.uint8),
         "float255": rgb.clip(0, 1) * 255}[colour]
    kw = dict(binary=fmt != "ascii", double_precision=fmt == "binary_double")
    pply.write_ply(str(tmp_path / "p.ply"), xyz, c, **kw)
    tply.write_ply(str(tmp_path / "t.ply"), xyz, c, **kw)
    assert _bytes(tmp_path / "p.ply") == _bytes(tmp_path / "t.ply")


def test_write_ply_native_equals_numpy(rng, tmp_path, monkeypatch):
    xyz, rgb = _cloud(rng)
    pply.write_ply(str(tmp_path / "n.ply"), xyz, rgb)
    monkeypatch.setattr(pnat, "get_lib", lambda: None)
    pply.write_ply(str(tmp_path / "p.ply"), xyz, rgb)
    assert _bytes(tmp_path / "n.ply") == _bytes(tmp_path / "p.ply")


def test_write_ply_empty(tmp_path):
    xyz = np.zeros((0, 3), np.float32)
    pply.write_ply(str(tmp_path / "p.ply"), xyz, np.zeros((0, 3)))
    tply.write_ply(str(tmp_path / "t.ply"), xyz, np.zeros((0, 3)))
    assert _bytes(tmp_path / "p.ply") == _bytes(tmp_path / "t.ply")
    got, col = pply.read_ply(str(tmp_path / "p.ply"))
    assert got.shape == (0, 3) and col.shape == (0, 3)


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("with_rgb", [True, False])
def test_write_pcd_bytes_equal_txr(rng, tmp_path, binary, with_rgb):
    xyz, rgb = _cloud(rng)
    c = rgb if with_rgb else None
    pply.write_pcd(str(tmp_path / "p.pcd"), xyz, c, binary=binary)
    tply.write_pcd(str(tmp_path / "t.pcd"), xyz, c, binary=binary)
    assert _bytes(tmp_path / "p.pcd") == _bytes(tmp_path / "t.pcd")


@pytest.mark.parametrize("codec", ["native", "cv2"])
def test_save_depth_png16_bytes_equal_txr(rng, tmp_path, request, codec):
    if codec == "cv2":
        request.getfixturevalue("native_off")
    depth = rng.uniform(0.05, 60.0, (40, 56)).astype(np.float32)
    depth[0, :4] = [65.535, 65.536, 70.0, 0.0]     # the uint16 cast wraps
    pdio.save_depth_png16(str(tmp_path / "p.png"), depth)
    tdio.save_depth_png16(str(tmp_path / "t.png"), depth)
    assert _bytes(tmp_path / "p.png") == _bytes(tmp_path / "t.png")
    back = cv2.imread(str(tmp_path / "p.png"), cv2.IMREAD_ANYDEPTH)
    np.testing.assert_array_equal(back, (depth * 1000).astype(np.uint16))


def test_save_depth_png16_needs_a_codec(rng, tmp_path, native_off, cv2_off):
    with pytest.raises(IOError, match="PNG codec"):
        pdio.save_depth_png16(str(tmp_path / "p.png"), np.ones((4, 4)))


def test_save_depth_npy_bytes_equal_txr(rng, tmp_path):
    depth = rng.uniform(0, 10, (33, 47))                # float64 in
    pdio.save_depth_npy(str(tmp_path / "p.npy"), depth)
    tdio.save_depth_npy(str(tmp_path / "t.npy"), depth)
    assert _bytes(tmp_path / "p.npy") == _bytes(tmp_path / "t.npy")


@pytest.mark.parametrize("name", ["jet", "magma", "inferno", "viridis",
                                  "plasma", "turbo", "TURBO", "rainbow"])
def test_colormap_equal_txr(rng, tmp_path, name):
    assert pdio.get_colormap(name) == tdio.get_colormap(name)
    depth = rng.uniform(0, 5, (20, 30)).astype(np.float32)
    depth[0, 0] = np.nan
    np.testing.assert_array_equal(pdio.depth_to_colormap(depth, name),
                                  tdio.depth_to_colormap(depth, name))
    pdio.save_depth_vis(str(tmp_path / "p.png"), depth, name)
    tdio.save_depth_vis(str(tmp_path / "t.png"), depth, name)
    assert _bytes(tmp_path / "p.png") == _bytes(tmp_path / "t.png")


def test_colormap_without_cv2(cv2_off):
    assert pdio.get_colormap("turbo") == 2
    with pytest.raises(IOError, match="OpenCV"):
        pdio.depth_to_colormap(np.ones((3, 3)))


# -------------------------------------------------------------- readers


@pytest.mark.parametrize("fmt", ["binary", "ascii", "binary_double"])
@pytest.mark.parametrize("with_rgb", [True, False])
def test_read_ply_equal_txr(rng, tmp_path, fmt, with_rgb):
    xyz, rgb = _cloud(rng)
    path = str(tmp_path / "c.ply")
    tply.write_ply(path, xyz, rgb if with_rgb else None,
                   binary=fmt != "ascii",
                   double_precision=fmt == "binary_double")
    got, want = pply.read_ply(path), tply.read_ply(path)
    np.testing.assert_array_equal(got[0], want[0])
    if with_rgb:
        np.testing.assert_array_equal(got[1], want[1])
    else:
        assert got[1] is None and want[1] is None


def test_read_ply_rejects_what_txr_rejects(tmp_path):
    (tmp_path / "a.ply").write_bytes(b"not a ply\n")
    (tmp_path / "b.ply").write_bytes(b"ply\nformat ascii 1.0\n")
    for name in ("a.ply", "b.ply"):
        with pytest.raises(ValueError):
            pply.read_ply(str(tmp_path / name))
        with pytest.raises(ValueError):
            tply.read_ply(str(tmp_path / name))


@pytest.mark.parametrize("kind", ["npy", "png_native", "png_cv2", "tiff",
                                  "png8"])
def test_load_depth_equal_txr(rng, tmp_path, request, kind):
    depth = rng.uniform(0.1, 20.0, (24, 36)).astype(np.float32)
    if kind == "npy":
        path = tmp_path / "d.npy"
        np.save(path, depth.astype(np.float64))
    elif kind == "tiff":
        path = tmp_path / "d.tiff"
        cv2.imwrite(str(path), depth)
    elif kind == "png8":
        path = tmp_path / "d.png"
        cv2.imwrite(str(path), (depth * 10).astype(np.uint8))
    else:
        if kind == "png_cv2":
            request.getfixturevalue("native_off")
        path = tmp_path / "d.png"
        cv2.imwrite(str(path), (depth * 1000).astype(np.uint16))
    got = pdio.load_depth(str(path))
    want = tdio.load_depth(str(path))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_load_depth_without_cv2(tmp_path, native_off, cv2_off):
    np.save(tmp_path / "d.npy", np.ones((2, 2)))
    assert pdio.load_depth(str(tmp_path / "d.npy")).shape == (2, 2)
    (tmp_path / "d.exr").write_bytes(b"")
    with pytest.raises(IOError, match="OpenCV"):
        pdio.load_depth(str(tmp_path / "d.exr"))


@pytest.mark.parametrize("name", ["frame_0001_depth.npy", "frame_0001.png",
                                  "depth_frame_0001.png", None])
def test_find_matching_depth_equal_txr(tmp_path, name):
    if name:
        (tmp_path / name).write_bytes(b"")
    rgb = str(tmp_path / "rgb" / "frame_0001.jpg")
    assert pdio.find_matching_depth(rgb, str(tmp_path)) == \
        tdio.find_matching_depth(rgb, str(tmp_path))
    assert pdio.DepthImageLoader.find_matching_depth(
        "frame_0001.jpg", tmp_path) == tdio.DepthImageLoader.\
        find_matching_depth("frame_0001.jpg", tmp_path)


# -------------------------------------------------------------- sources


@pytest.fixture(scope="module")
def frame_folder(tmp_path_factory):
    d = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(0)
    for i in range(5):
        img = rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)
        cv2.imwrite(str(d / f"frame_{i:04d}.jpg"), img)
    cv2.imwrite(str(d / "frame_0005.png"),
                rng.integers(0, 255, (48, 64, 3), dtype=np.uint8))
    (d / "frame_0006.jpg").write_bytes(b"unreadable")   # skipped
    (d / "notes.txt").write_text("not an image")
    return str(d)


def _frames(src):
    return [(img, ts, name) for img, ts, name in src]


def _same_frames(got, want):
    assert [(ts, name) for _, ts, name in got] == \
        [(ts, name) for _, ts, name in want]
    for (g, _, _), (w, _, _) in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("opencv", [True, False], ids=["cv2", "no_cv2"])
def test_folder_source_equal_txr(frame_folder, request, opencv):
    if not opencv:
        if pnat.get_lib() is None or not pnat.codecs()["jpeg"]:
            pytest.skip("no native JPEG decoder")
        request.getfixturevalue("cv2_off")
    got, want = psrc.FolderSource(frame_folder), tsrc.FolderSource(
        frame_folder)
    assert len(got) == len(want) == 7
    assert dataclasses.asdict(got.intrinsics) == dataclasses.asdict(
        want.intrinsics)
    gf, wf = _frames(got), _frames(want)
    _same_frames(gf, wf)
    # the PNG needs cv2, the broken JPEG is always skipped
    assert len(gf) == (6 if opencv else 5)


def test_folder_source_intrinsics_file_and_errors(frame_folder, tmp_path):
    p = tmp_path / "intr.json"
    p.write_text(json.dumps({"fx": 600, "fy": 500, "cx": 31, "cy": 22,
                             "width": 64, "height": 48}))
    got = psrc.FolderSource(frame_folder, str(p)).intrinsics
    assert got == psrc.CameraIntrinsics.from_json(str(p))
    assert dataclasses.asdict(got) == dataclasses.asdict(
        tsrc.FolderSource(frame_folder, str(p)).intrinsics)
    with pytest.raises(FileNotFoundError):
        psrc.FolderSource(str(tmp_path / "empty"))


def test_prefetch_source_equal_txr(frame_folder):
    got = psrc.PrefetchSource(psrc.FolderSource(frame_folder), depth=2)
    assert got.intrinsics is got.inner.intrinsics and not got.realtime
    _same_frames(_frames(got), _frames(tsrc.FolderSource(frame_folder)))
    got.close()
    early = psrc.PrefetchSource(psrc.FolderSource(frame_folder), depth=1)
    next(early)
    early.close()                               # stops the worker
    early._thread.join(timeout=10)
    assert not early._thread.is_alive()


class _ClosingSource(psrc.FolderSource):
    """FolderSource that records, when closed, whether its prefetch worker
    was still running."""

    owner = None
    worker_alive_at_close = None

    def close(self):
        self.worker_alive_at_close = self.owner._thread.is_alive()
        super().close()


def test_prefetch_close_stops_the_worker_every_time(frame_folder):
    """close() after one next() at depth 1 stops the worker in every one of
    200 tries (the worker used to block on a full queue after the drain),
    and closes the inner source only after the worker has stopped."""
    for _ in range(200):
        inner = _ClosingSource(frame_folder)
        early = psrc.PrefetchSource(inner, depth=1)
        inner.owner = early
        next(early)
        early.close()
        early._thread.join(timeout=2)
        assert not early._thread.is_alive()
        assert inner.worker_alive_at_close is False


def test_make_source(frame_folder):
    assert isinstance(psrc.make_source("folder", frame_folder),
                      psrc.PrefetchSource)
    assert isinstance(psrc.make_source("folder", frame_folder,
                                       prefetch=False), psrc.FolderSource)
    with pytest.raises(ValueError, match="video-path"):
        psrc.make_source("video")
    with pytest.raises(ValueError, match="Unknown"):
        psrc.make_source("lidar")


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("video") / "in.avi")
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10,
                         (64, 48))
    rng = np.random.default_rng(1)
    for _ in range(7):
        vw.write(rng.integers(0, 255, (48, 64, 3), dtype=np.uint8))
    vw.release()
    return path


class _FlakyCap:
    """cv2.VideoCapture stand-in that fails reads at given frame indices."""

    def __init__(self, cap, bad):
        self._cap, self._bad, self._pos = cap, set(bad), 0

    def set(self, prop, val):
        self._pos = int(val)
        return self._cap.set(prop, val)

    def read(self):
        if self._pos in self._bad:
            return False, None
        return self._cap.read()

    def release(self):
        self._cap.release()


@pytest.mark.parametrize("mode", [("all", 100.0), ("custom", 50.0),
                                  ("1fps", 100.0)])
def test_video_source_equal_txr(video, mode):
    got = psrc.VideoSource(video, *mode)
    want = tsrc.VideoSource(video, *mode)
    assert dataclasses.asdict(got.intrinsics) == dataclasses.asdict(
        want.intrinsics)
    _same_frames(_frames(got), _frames(want))
    got.close()
    want.close()


def test_video_source_skips_a_bad_frame(video):
    got = psrc.VideoSource(video, fps_mode="all")
    got.cap = _FlakyCap(got.cap, bad=[2, 5])
    want = tsrc.VideoSource(video, fps_mode="all")
    want.cap = _FlakyCap(want.cap, bad=[2, 5])
    gf = _frames(got)
    assert [n for _, _, n in gf] == [f"frame_{i:06d}" for i in (0, 1, 3, 4, 6)]
    _same_frames(gf, _frames(want))


def test_video_and_camera_need_cv2(video, cv2_off):
    with pytest.raises(ImportError, match="video"):
        psrc.VideoSource(video)
    with pytest.raises(ImportError, match="camera"):
        psrc.CameraSource(0)


def test_camera_source_is_realtime():
    assert psrc.CameraSource.realtime and not psrc.FolderSource.realtime
    assert psrc.CameraSource.realtime == tsrc.CameraSource.realtime


# --------------------------------------------------------------- rtabmap


def test_rtabmap_replay_equal_txr(rtabmap_db):
    got, want = prdb.RTABMapDBSource(rtabmap_db), trdb.RTABMapDBSource(
        rtabmap_db)
    assert len(got) == len(want) == 5
    assert dataclasses.asdict(got.intrinsics) == dataclasses.asdict(
        want.intrinsics)
    _same_frames(_frames(got), _frames(want))
    got.close()
    want.close()
    assert prdb.db_info(rtabmap_db) == trdb.db_info(rtabmap_db)


def test_rtabmap_loop_and_rescale(rtabmap_db, tmp_path):
    src = prdb.RTABMapDBSource(rtabmap_db, loop=True)
    seen = [next(src)[2] for _ in range(7)]
    assert seen[0] == seen[5] == "node_000001"
    src.close()
    db = tmp_path / "mismatch.db"
    conn = sqlite3.connect(db)
    conn.execute("CREATE TABLE Node (id INTEGER PRIMARY KEY, stamp REAL)")
    conn.execute("CREATE TABLE Data (id INTEGER PRIMARY KEY, image BLOB, "
                 "calibration BLOB)")
    ok, jpeg = cv2.imencode(".jpg", np.zeros((480, 640, 3), np.uint8))
    conn.execute("INSERT INTO Node VALUES (1, 0.0)")
    conn.execute("INSERT INTO Data VALUES (1, ?, ?)", (jpeg.tobytes(),
                  make_calib_blob(1000.0, 1000.0, 640.0, 480.0, 1280, 960)))
    conn.commit()
    conn.close()
    src = prdb.RTABMapDBSource(str(db))
    next(src)
    assert src.intrinsics.fx == 500.0 and src.intrinsics.width == 640
    src.close()


@pytest.mark.parametrize("blob", [make_calib_blob(600.0, 610.0, 319.5, 239.5,
                                                  640, 480),
                                  make_calib_blob(0.0, 1.0, 1.0, 1.0, 4, 4),
                                  b"\x01\x02"])
def test_calibration_blob_equal_txr(blob):
    got = prdb.parse_calibration_blob(blob)
    want = trdb.parse_calibration_blob(blob)
    if want is None:
        assert got is None
    else:
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_rtabmap_all_corrupt_stops(tmp_path):
    db = tmp_path / "bad.db"
    conn = sqlite3.connect(db)
    conn.execute("CREATE TABLE Node (id INTEGER PRIMARY KEY, stamp REAL)")
    conn.execute("CREATE TABLE Data (id INTEGER PRIMARY KEY, image BLOB, "
                 "calibration BLOB)")
    for i in (1, 2):
        conn.execute("INSERT INTO Node VALUES (?, 0.0)", (i,))
        conn.execute("INSERT INTO Data VALUES (?, ?, NULL)",
                     (i, b"not a jpeg"))
    conn.commit()
    conn.close()
    src = prdb.RTABMapDBSource(str(db), loop=True)
    with pytest.raises(StopIteration):
        next(src)
    src.close()


# ------------------------------------------------------- ROS2 and configs


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("colour", ["none", "float", "uint8"])
def test_pointcloud2_bytes_equal_txr(rng, request, native, colour):
    if not native:
        request.getfixturevalue("native_off")
    xyz, rgb = _cloud(rng, 100)
    c = {"none": None, "float": rgb,
         "uint8": (rgb.clip(0, 1) * 255).astype(np.uint8)}[colour]
    got = ppub.pack_pointcloud2_data(xyz, c)
    assert got == tpub.pack_pointcloud2_data(xyz, c)
    assert len(got) == 100 * (12 if c is None else 16)
    # the native packer and the numpy one agree on colours in [0, 1] (out
    # of range, the C++ cast of a negative float differs from numpy's clip,
    # in txr as here)
    c_in = None if c is None else c[4:]
    assert ppub.pack_pointcloud2_data(xyz[4:], c_in) == \
        ppub.pack_pointcloud2_numpy(xyz[4:], c_in)


def test_ros2_optional():
    assert ppub.ros2_available() == tpub.ros2_available()
    if not ppub.ros2_available():
        with pytest.raises(RuntimeError, match="rclpy"):
            ppub.ROS2DepthPublisher()


@pytest.mark.parametrize("pair", [(ReconstructionConfig, TRecon),
                                  (StreamingConfig, TStream)])
def test_config_defaults_equal_txr(pair):
    got, want = pair[0](), pair[1]()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    if hasattr(want, "K"):
        np.testing.assert_array_equal(got.K, want.K)


def test_io_package_exports_txr_names():
    import txr.io as tio

    assert sorted(pio.__all__) == sorted(tio.__all__)
