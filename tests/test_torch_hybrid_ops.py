"""The enhanced CLI's feature ops on the port against ``txr`` on the CPU:
Canny, ORB (``_brief_pattern``, the pyramid, FAST-9, Harris, steered BRIEF),
LSD (label propagation, the per-component sums through the segmented scan,
``_seg_scan_max``), ``ORBDetector`` on both backends; then the hybrid
detector (both backends, ``detect`` against ``detect_batch``), hybrid
matching, line-endpoint NCC matching, the depth-guided filter, dense
correspondences and bundle adjustment (``build_problem``,
``bundle_adjust``). ``tests/test_torch_enhanced.py`` holds the pipeline
and the CLI.

The same seeded uint8 images go to both packages. Where ``txr`` reaches the
scan kernel it runs its XLA reference on the CPU, and the port its plain
version. Tolerances:

- Canny and ``_brief_pattern``: bit-equal (Sobel on uint8 is exact in f32).
- ORB: the same mask, pixel positions, sizes and descriptors, bit for bit;
  responses within 1e-5 of the largest, and angles within 1e-2 degrees
  (the 7x7 box filter and the 31x31 moment sums add in another order).
- ``ORBDetector``: the same keypoints; descriptors bit for bit with
  OpenCV, within 0.5 % of their bits on the device backend's flat image.
- LSD: the same segment count and mask; each segment of one side within
  1e-3 px (endpoints) and 1e-3 px (width) of one of the other's, with the
  same support. The order of the kept segments may differ where two
  lengths differ in the last bits (the top-k sorts them).
- The hybrid detector: OpenCV's features and everything downstream of them
  on the host bit for bit; on the device backend edges and grey bit for
  bit, lines and ORB keypoints as sets (as above), SIFT keypoints within
  1e-2 px (``tests/test_torch_features.py``'s tolerance).
- RANSAC-F of ``DepthEnhancedReconstruction.match_image_pair`` over the
  match capacity, on ``txr``'s draw: the same inliers, bit for bit.
- Bundle adjustment: poses within 1e-5, points within 1e-4, the RMS
  history within 1e-5 relative (closed-form Jacobians against
  ``jax.jacfwd``, sums in another order).
"""

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_bundle_adjustment import make_ba_scene  # noqa: E402
from txr.geometry import bundle_adjustment as jba  # noqa: E402
from txr.geometry import hybrid as jhy  # noqa: E402
from txr.geometry.features import ORBDetector as JORBDetector  # noqa: E402
from txr.ops.canny import canny as j_canny  # noqa: E402
from txr.ops.lsd import _seg_scan_max as j_seg_max  # noqa: E402
from txr.ops.lsd import lsd_lines as j_lsd  # noqa: E402
from txr.ops.orb import _brief_pattern as j_brief  # noqa: E402
from txr.ops.orb import orb_features as j_orb  # noqa: E402
from txr.pipelines import enhanced_pipeline as jenh  # noqa: E402
from txr_torch.geometry import bundle_adjustment as tba  # noqa: E402
from txr_torch.geometry import hybrid as thy  # noqa: E402
from txr_torch.geometry.features import ORBDetector  # noqa: E402
from txr_torch.ops.canny import canny  # noqa: E402
from txr_torch.ops.lsd import _seg_scan_max, lsd_lines  # noqa: E402
from txr_torch.ops.orb import _brief_pattern, orb_features  # noqa: E402
from txr_torch.pipelines import enhanced_pipeline as tenh  # noqa: E402

torch.set_num_threads(1)

LINE_TOL = 1e-3


def blocky(seed: int, h: int, w: int, block: int = 8,
           noise: int = 20) -> np.ndarray:
    """Seeded blocks of random grey levels with noise on top."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h // block + 1, w // block + 1))
    img = np.kron(img, np.ones((block, block), np.int64))[:h, :w]
    if noise:
        img = img + rng.integers(-noise, noise + 1, (h, w))
    return np.clip(img, 0, 255).astype(np.uint8)


def drawn_lines(seed: int, h: int = 120, w: int = 160) -> np.ndarray:
    rng = np.random.default_rng(seed)
    img = np.full((h, w), 90, np.uint8)
    for _ in range(12):
        p1 = tuple(int(v) for v in rng.integers(0, [w, h]))
        p2 = tuple(int(v) for v in rng.integers(0, [w, h]))
        cv2.line(img, p1, p2, int(rng.integers(150, 256)), 2)
    return img


IMAGES = {
    "blocky_120x160": lambda: blocky(0, 120, 160),
    "noisy_97x131": lambda: blocky(1, 97, 131, block=5, noise=40),
    "flat": lambda: np.full((64, 80), 128, np.uint8),
}


# ---------------------------------------------------------------- Canny

@pytest.mark.parametrize("l2", [False, True])
@pytest.mark.parametrize("name", sorted(IMAGES))
def test_canny_bit_equal(name, l2):
    img = IMAGES[name]()
    want = np.asarray(j_canny(jnp.asarray(img), l2gradient=l2))
    got = canny(torch.from_numpy(img), l2gradient=l2)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    if name != "flat":
        assert (want > 0).sum() > 100


# ------------------------------------------------------------------ ORB

def test_brief_pattern_bit_equal():
    np.testing.assert_array_equal(_brief_pattern(), j_brief())
    assert _brief_pattern().dtype == j_brief().dtype


@pytest.mark.parametrize("shape,levels,cap", [((120, 160), 3, 256),
                                              ((97, 131), 8, 256),
                                              ((120, 160), 8, 512)])
def test_orb_matches_txr(shape, levels, cap):
    img = blocky(2, *shape, block=6, noise=10)
    want = j_orb(jnp.asarray(img), capacity=cap, n_levels=levels)
    got = orb_features(torch.from_numpy(img), capacity=cap, n_levels=levels)
    mask = np.asarray(want.mask)
    np.testing.assert_array_equal(got.mask.numpy(), mask)
    assert mask.sum() > 50
    for name in ("uv", "size", "desc"):
        np.testing.assert_array_equal(getattr(got, name).numpy()[mask],
                                      np.asarray(getattr(want, name))[mask],
                                      err_msg=name)
    resp = np.asarray(want.response)[mask]
    np.testing.assert_allclose(got.response.numpy()[mask], resp, rtol=1e-5,
                               atol=1e-5 * np.abs(resp).max())
    d = np.abs(got.angle.numpy() - np.asarray(want.angle))[mask]
    assert np.minimum(d, 360.0 - d).max() < 1e-2


# ------------------------------------------------------------------ LSD

def _same_segments(got, want):
    gm, wm = got.mask.numpy(), np.asarray(want.mask)
    assert gm.sum() == wm.sum()
    np.testing.assert_array_equal(gm, wm)
    gl, wl = got.lines.numpy()[gm], np.asarray(want.lines)[wm]
    d = np.abs(gl[:, None, :] - wl[None, :, :]).max(-1)
    near = d.argmin(1)
    assert d.min(1).max() < LINE_TOL
    assert len(set(near.tolist())) == len(near)       # one to one
    np.testing.assert_allclose(got.width.numpy()[gm],
                               np.asarray(want.width)[wm][near],
                               atol=LINE_TOL)
    np.testing.assert_array_equal(got.count.numpy()[gm],
                                  np.asarray(want.count)[wm][near])


@pytest.mark.parametrize("name,make", [
    ("blocky", lambda: blocky(3, 120, 160, block=12, noise=0)),
    ("blocky_odd", lambda: blocky(4, 97, 131, block=12, noise=0)),
    ("drawn_lines", lambda: drawn_lines(5))])
def test_lsd_matches_txr(name, make):
    img = make()
    want = j_lsd(jnp.asarray(img))
    got = lsd_lines(torch.from_numpy(img))
    assert got.lines.shape == (512, 4) and got.count.dtype == torch.int32
    assert int(got.mask.sum()) > 10
    _same_segments(got, want)


def test_lsd_float_input_and_capacity():
    img = blocky(6, 96, 128, block=12, noise=0)
    f = img.astype(np.float32) / 255.0
    want = j_lsd(jnp.asarray(f), capacity=16)
    got = lsd_lines(torch.from_numpy(f), capacity=16)
    assert got.lines.shape == (16, 4)
    _same_segments(got, want)


@pytest.mark.parametrize("n", [1, 37, 1000])
def test_seg_scan_max_at_segment_ends(n):
    rng = np.random.default_rng(n)
    vals = rng.normal(size=(n, 4)).astype(np.float32)
    starts = rng.random(n) < 0.2
    starts[0] = True
    want = np.asarray(j_seg_max(jnp.asarray(vals), jnp.asarray(starts)))
    got = _seg_scan_max(torch.from_numpy(vals), torch.from_numpy(starts))
    last = np.r_[starts[1:], True]
    np.testing.assert_array_equal(got.numpy()[last], want[last])


# --------------------------------------------------------- ORBDetector

def _bgr(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    img = np.full((120, 160, 3), 100, np.uint8)
    for _ in range(30):
        c = rng.integers(0, 255, 3).tolist()
        p = (int(rng.integers(5, 150)), int(rng.integers(5, 110)))
        cv2.rectangle(img, p, (p[0] + 9, p[1] + 7), c, -1)
    return img


@pytest.mark.parametrize("backend", ["cv2", "device"])
def test_orb_detector_matches_txr(backend):
    """The same keypoints on both backends (the device backend's grey is
    OpenCV's, bit for bit, in both packages here); OpenCV's descriptors
    bit for bit, the device's within 0.5 % of their bits: on this image's
    flat rectangles two blurred taps tie, and the blur's summation order
    decides their comparison."""
    img = _bgr(7)
    want = JORBDetector(capacity=512, backend=backend).detect(img)
    det = ORBDetector(capacity=512, backend=backend, device="cpu")
    got = det.detect(img)
    assert det.backend == backend and got.kind == "orb"
    assert got.uv.shape == (512, 2) and got.desc.shape == (512, 32)
    mask = np.asarray(want.mask)
    assert mask.sum() > 30
    np.testing.assert_array_equal(got.mask.numpy(), mask)
    np.testing.assert_array_equal(got.uv.numpy()[mask],
                                  np.asarray(want.uv)[mask])
    bits = np.unpackbits(got.desc.numpy()[mask]
                         ^ np.asarray(want.desc)[mask]).sum()
    assert bits <= (0 if backend == "cv2" else 0.005 * mask.sum() * 256)


def test_orb_detector_needs_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ORBDetector()


def _enhanced_scene() -> list:
    """``tests/test_enhanced_pipeline.py:170-215``'s three frames (35
    coloured rectangles on grey, shifted sideways, 160 x 120)."""
    rng = np.random.default_rng(3)
    base = np.full((120, 160, 3), 90, np.uint8)
    for _ in range(35):
        c = rng.integers(0, 255, 3).tolist()
        p = (int(rng.integers(10, 150)), int(rng.integers(10, 110)))
        cv2.rectangle(base, p, (p[0] + 8, p[1] + 6), c, -1)
    return [cv2.warpAffine(base, np.float32([[1, 0, dx], [0, 1, 0]]),
                           (160, 120)) for dx in (0, 7, 14)]


# ------------------------------------------------------- hybrid detection

@pytest.fixture(scope="module")
def textured_pair():
    """``tests/test_enhanced_pipeline.py``'s textured pair (lines and
    rectangles, the second shifted by (12, 5))."""
    rng = np.random.default_rng(5)
    img = np.full((240, 320, 3), 100, np.uint8)
    for _ in range(30):
        c = rng.integers(0, 255, 3).tolist()
        p1 = (int(rng.integers(20, 300)), int(rng.integers(20, 220)))
        p2 = (int(rng.integers(20, 300)), int(rng.integers(20, 220)))
        cv2.line(img, p1, p2, c, 2)
        cv2.rectangle(img, p1, (p1[0] + 15, p1[1] + 10), c, -1)
    shifted = cv2.warpAffine(img, np.float32([[1, 0, 12], [0, 1, 5]]),
                             (320, 240))
    return img, shifted


def _uv(f):
    return np.asarray(f.uv)[np.asarray(f.mask)]


def test_cv2_hybrid_detect_and_match_equal_txr(textured_pair):
    jd = jhy.HybridFeatureDetector(verbose=False, backend="cv2")
    td = thy.HybridFeatureDetector(verbose=False, backend="cv2",
                                   device="cpu")
    want = [jd.detect(im) for im in textured_pair]
    got = [td.detect(im) for im in textured_pair]
    for w, g in zip(want, got):
        for kind in ("sift", "orb"):
            np.testing.assert_array_equal(_uv(getattr(g, kind)),
                                          _uv(getattr(w, kind)))
            np.testing.assert_array_equal(
                getattr(g, kind).desc.numpy(),
                np.asarray(getattr(w, kind).desc))
        np.testing.assert_array_equal(g.lines, w.lines)
        np.testing.assert_array_equal(g.edges, w.edges)
        np.testing.assert_array_equal(g.gray, w.gray)
    p_want = jd.match_features(*want)
    p_got = td.match_features(*got)
    assert len(p_want[0]) > 30
    for a, b in zip(p_got, p_want):
        np.testing.assert_array_equal(a, b)


def _same_set(a, b, tol):
    """Every row of a within tol of a row of b, and the same count."""
    assert len(a) == len(b)
    if len(a):
        d = np.abs(a[:, None, :] - b[None, :, :]).max(-1)
        assert d.min(1).max() < tol and d.min(0).max() < tol


@pytest.fixture(scope="module")
def device_features():
    frames = _enhanced_scene()
    jd = jhy.HybridFeatureDetector(verbose=False, backend="device")
    td = thy.HybridFeatureDetector(verbose=False, backend="device",
                                   device="cpu")
    return frames, td, jd.detect_batch(frames), td.detect_batch(frames)


def test_device_hybrid_detect_matches_txr(device_features):
    """Edges and grey bit for bit, lines and ORB keypoints as sets (equal
    responses may rank in another order), SIFT within 1e-2 px."""
    _, _, want, got = device_features
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.edges, w.edges)
        np.testing.assert_array_equal(g.gray, w.gray)
        _same_set(g.lines, w.lines, 1e-3)
        _same_set(_uv(g.orb), _uv(w.orb), 1e-6)
        _same_set(_uv(g.sift), _uv(w.sift), 1e-2)
        assert g.sift.count > 10 and g.orb.count > 10


def test_device_detect_equals_detect_batch(device_features):
    frames, td, _, got = device_features
    one = td.detect(frames[1])
    for kind in ("sift", "orb"):
        for name in ("uv", "desc", "mask"):
            assert torch.equal(getattr(getattr(one, kind), name),
                               getattr(getattr(got[1], kind), name))
    np.testing.assert_array_equal(one.lines, got[1].lines)
    np.testing.assert_array_equal(one.edges, got[1].edges)


def test_disabled_modalities():
    td = thy.HybridFeatureDetector(use_orb=False, use_lines=False,
                                   use_edges=False, verbose=False,
                                   backend="device", device="cpu")
    f = td.detect_batch(_enhanced_scene()[:1])[0]
    assert f.orb is None and f.lines is None and f.edges is None
    assert f.sift is not None and f.sift.count > 10


# ------------------------------------------------------- host matching

def test_match_line_endpoints_equal_txr(textured_pair):
    lsd = cv2.createLineSegmentDetector(cv2.LSD_REFINE_STD)
    g1, g2 = (cv2.cvtColor(im, cv2.COLOR_BGR2GRAY) for im in textured_pair)
    l1, l2 = (lsd.detect(g)[0].reshape(-1, 4) for g in (g1, g2))
    want = jhy.match_line_endpoints(l1, l2, g1, g2)
    got = thy.match_line_endpoints(l1, l2, g1, g2)
    assert len(want[0]) > 5
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    empty = thy.match_line_endpoints(np.zeros((0, 4)), l2, g1, g2)
    assert empty[0].shape == (0, 2)


@pytest.mark.parametrize("with_depth", [True, False])
def test_depth_guided_matcher_equals_txr(with_depth):
    rng = np.random.default_rng(11)
    pts1 = rng.uniform(5, 45, (40, 2)).astype(np.float32)
    pts2 = pts1 + 1.0
    d1 = rng.uniform(1, 5, (50, 50)).astype(np.float32)
    d2 = np.where(rng.random((50, 50)) < 0.3, 6.0 - d1, d1)
    args = (pts1, pts2, d1, d2) if with_depth else (pts1, pts2, None, None)
    want = jhy.DepthGuidedMatcher().filter_matches_by_depth(*args)
    got = thy.DepthGuidedMatcher().filter_matches_by_depth(*args)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_dense_correspondences_equal_txr():
    rng = np.random.default_rng(12)
    d1 = rng.uniform(1.0, 3.0, (48, 64)).astype(np.float32)
    d1[::7] = 0.0
    R = jba._so3_exp(jax.numpy.asarray([0.01, -0.02, 0.005]))
    args = (d1, d1, np.asarray(R), np.array([0.1, 0.02, 0.0]),
            np.array([[50.0, 0, 32], [0, 50.0, 24], [0, 0, 1]]), 8)
    want = jhy.generate_dense_correspondences(*args)
    got = thy.generate_dense_correspondences(*args)
    assert len(want[0]) > 20
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------- bundle adjustment

@pytest.fixture(scope="module")
def ba_scene():
    rng = np.random.default_rng(0)
    K, poses, X, obs = make_ba_scene(rng, noise_px=0.3)
    noisy = [poses[0]]
    for R, t in poses[1:]:
        dR = np.eye(3) + np.cross(np.eye(3), rng.normal(0, 0.01, 3))
        u, _, vt = np.linalg.svd(dR)
        noisy.append((u @ vt @ R, t + rng.normal(0, 0.02, 3)))
    nX = X + rng.normal(0, 0.05, X.shape)
    for i in range(0, len(obs), 20):           # 5 % gross outliers
        ci, pi, p = obs[i]
        obs[i] = (ci, pi, p + np.array([80.0, -60.0]))
    return K, noisy, nX, obs


def test_build_problem_equals_txr(ba_scene):
    K, poses, X, obs = ba_scene
    want = jba.build_problem(poses, X, obs, max_obs=len(obs) + 5)
    got = tba.build_problem(poses, X, obs, max_obs=len(obs) + 5,
                            device="cpu")
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


@pytest.mark.parametrize("iterations", [1, 6])
def test_bundle_adjust_matches_txr(ba_scene, iterations):
    K, poses, X, obs = ba_scene
    Kf = K.astype(np.float32)
    want = jba.bundle_adjust(jba.build_problem(poses, X, obs),
                             jax.numpy.asarray(Kf), iterations=iterations)
    got = tba.bundle_adjust(tba.build_problem(poses, X, obs, device="cpu"),
                            torch.from_numpy(Kf), iterations=iterations)
    R, t, Xo, hist = (a.numpy() for a in got)
    np.testing.assert_allclose(R, np.asarray(want[0]), atol=1e-5)
    np.testing.assert_allclose(t, np.asarray(want[1]), atol=1e-5)
    np.testing.assert_allclose(Xo, np.asarray(want[2]), atol=1e-4)
    np.testing.assert_allclose(hist, np.asarray(want[3]), rtol=1e-5)
    assert hist.shape == (iterations + 1,) and hist[-1] < hist[0]
    np.testing.assert_array_equal(R[0], poses[0][0].astype(np.float32))


def test_match_pair_over_capacity_matches_txr(monkeypatch):
    """More raw matches than MATCH_CAPACITY are cut to the capacity and
    give txr's RANSAC-F inliers on txr's draw."""
    rng = np.random.default_rng(13)
    n = tenh.MATCH_CAPACITY + 1000
    pts1 = rng.uniform(0, 128, (n, 2)).astype(np.float32)
    pts2 = pts1 + np.float32([2.0, 0.0])
    off = rng.uniform(25, 50, len(pts2[::9])) * rng.choice([-1, 1],
                                                            len(pts2[::9]))
    pts2[::9, 1] += off.astype(np.float32)    # far off the epipolar lines
    K = np.array([[100.0, 0, 64], [0, 100.0, 48], [0, 0, 1.0]])
    out = {}
    for side, mod in (("txr", jenh), ("port", tenh)):
        kw = {} if side == "txr" else dict(device="cpu")
        rec = mod.DepthEnhancedReconstruction(
            K, use_depth=False, use_hybrid_features=False, verbose=False,
            **kw)
        monkeypatch.setattr(rec, "_match_pair_host",
                            lambda i, j: (pts1, pts2))
        if side == "txr":
            out[side] = rec.match_image_pair(0, 1)
        else:
            kf = jax.random.split(jax.random.PRNGKey(0))[1]
            prio = torch.from_numpy(np.array(
                jax.random.uniform(kf, (1024, tenh.MATCH_CAPACITY))))
            out[side] = rec.match_image_pair(0, 1, priorities=prio)
    a, b = out["port"]
    assert 0 < len(a) == len(b) <= tenh.MATCH_CAPACITY
    for g, w in zip(out["port"], out["txr"]):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kind", ["l2", "hamming"])
def test_ratio_matching_ties_take_txr_index(kind):
    """Two candidates at the same distance: the first wins, as in txr (two
    L2 distances clamped to 0 pass the ratio test)."""
    from txr.ops import matching as jm
    from txr_torch.ops import matching as tm

    rng = np.random.default_rng(14)
    # small integers: every distance is exact in f32, so duplicates tie at 0
    a = rng.integers(0, 4 if kind == "l2" else 2,
                     (6, 128 if kind == "l2" else 256)).astype(np.float32)
    b = np.concatenate([a[::-1], a[:3]])
    ma, mb = np.ones(6, bool), np.ones(9, bool)
    fn_j = jm.match_l2_ratio if kind == "l2" else jm.match_hamming_ratio
    fn_t = tm.match_l2_ratio if kind == "l2" else tm.match_hamming_ratio
    want = fn_j(jnp.asarray(a), jnp.asarray(b), jnp.asarray(ma),
                jnp.asarray(mb), 0.75)
    got = fn_t(*(torch.from_numpy(x) for x in (a, b, ma, mb)), 0.75)
    ok = np.asarray(want[1])
    assert ok.all()
    np.testing.assert_array_equal(got[1].numpy(), ok)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
