"""The port's feature stage against ``txr``'s: CLAHE, SIFT, ratio matching
and ``geometry/features.py`` (detectors, matching, dedupe), on the same
numpy-seeded images, the port with ``device="cpu"``.

Tolerances:
- grey: bit-equal to ``cv2.cvtColor(BGR2GRAY)`` (``txr``'s grey where OpenCV
  is installed);
- CLAHE: at most 1 grey level, on at most 0.5 % of the pixels (``txr``'s
  XLA program and PyTorch round LUT blends that land on .5 differently);
- SIFT (96 x 128, capacity 256): the same valid set in the same order, uv
  and size within 1e-3 px, response within 1e-5, descriptors within 1e-4
  of their 0..255 range (2.55e-2): the blur and product sums run in another
  order;
- matching: the same indices and masks;
- the detectors end to end (grey -> CLAHE -> SIFT): the same valid set, uv
  within 1e-2 px and descriptors within 1.0: CLAHE's one-grey-level
  differences feed SIFT (measured 2.9e-3 px and 0.27).
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from txr.geometry.features import Features as JFeatures
from txr.geometry.features import SIFTDetector as JSIFTDetector
from txr.geometry.features import dedupe_matches as j_dedupe
from txr.geometry.features import match_features as j_match_features
from txr.ops.clahe import clahe as j_clahe
from txr.ops.matching import match_hamming_ratio as j_hamming
from txr.ops.matching import match_l2_ratio as j_l2
from txr.ops.matching import unpack_bits as j_unpack
from txr.ops.sift import sift_features as j_sift
from txr_torch.geometry.features import (Features, SIFTDetector,
                                         bgr_to_gray, dedupe_matches,
                                         match_features, resolve_backend)
from txr_torch.ops.clahe import clahe
from txr_torch.ops.matching import (match_hamming_ratio, match_l2_ratio,
                                    unpack_bits)
from txr_torch.ops.sift import sift_features

torch.set_num_threads(1)
cv2 = pytest.importorskip("cv2")

UV_TOL = 1e-3
DESC_TOL = 1e-4 * 255
DETECTOR_UV_TOL, DETECTOR_DESC_TOL = 1e-2, 1.0


def textured(rng, h=96, w=128, block=4, noise=40):
    """Blocky random texture plus pixel noise, uint8."""
    tex = rng.integers(0, 256, (h // block, w // block), dtype=np.uint8)
    img = np.kron(tex, np.ones((block, block), np.uint8)).astype(np.float32)
    img = img * 0.7 + rng.integers(0, noise, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def test_gray_matches_opencv(rng):
    bgr = rng.integers(0, 256, (64, 4096, 3), dtype=np.uint8)
    bgr[0, :256, 0] = np.arange(256)      # every value in every channel
    bgr[1, :256, 1] = np.arange(256)
    bgr[2, :256, 2] = np.arange(256)
    want = cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)
    np.testing.assert_array_equal(bgr_to_gray(torch.from_numpy(bgr)).numpy(),
                                  want)


@pytest.mark.parametrize("shape", [(96, 128), (101, 77), (8, 8)])
def test_clahe_matches_txr(rng, shape):
    img = textured(rng, 104, 136)[:shape[0], :shape[1]]
    want = np.asarray(j_clahe(jnp.asarray(img))).astype(np.int32)
    got = clahe(torch.from_numpy(img)).numpy()
    assert got.dtype == np.uint8 and got.shape == img.shape
    diff = np.abs(got.astype(np.int32) - want)
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 0.005


def _sift_pair(img, **kw):
    want = j_sift(jnp.asarray(img), **kw)
    got = sift_features(torch.from_numpy(img), **kw)
    return want, got


@pytest.mark.parametrize("kw", [
    dict(capacity=256, contrast_threshold=0.01, edge_threshold=15.0),
    dict(capacity=256, contrast_threshold=0.01, edge_threshold=15.0,
         n_features=100),
    dict(capacity=256)])
def test_sift_matches_txr(rng, kw):
    img = np.asarray(j_clahe(jnp.asarray(textured(rng))))
    want, got = _sift_pair(img, **kw)
    mask = np.asarray(want.mask)
    np.testing.assert_array_equal(got.mask.numpy(), mask)
    assert mask.sum() > 10
    for name, tol in (("uv", UV_TOL), ("size", UV_TOL), ("response", 1e-5),
                      ("desc", DESC_TOL)):
        g = getattr(got, name).numpy()[mask]
        w = np.asarray(getattr(want, name))[mask]
        np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=name)
    # angles within 1e-3 degrees, on the circle
    da = np.abs(got.angle.numpy()[mask] - np.asarray(want.angle)[mask])
    assert np.minimum(da, 360 - da).max() < 1e-3
    assert got.uv.shape == (kw["capacity"], 2)
    assert got.desc.shape == (kw["capacity"], 128)


def test_sift_float_input_and_flat_image():
    """A float image in [0, 1] equals its uint8 form / 255; a flat image
    has no keypoint."""
    img = textured(np.random.default_rng(5))
    a = sift_features(torch.from_numpy(img), capacity=128)
    b = sift_features(torch.from_numpy(img.astype(np.float32) / 255.0),
                      capacity=128)
    assert torch.equal(a.mask, b.mask) and torch.equal(a.uv, b.uv)
    flat = sift_features(torch.full((64, 64), 128, dtype=torch.uint8),
                         capacity=32)
    assert not flat.mask.any()


def _descriptors(rng, n1=300, n2=280, d=128):
    d2 = rng.uniform(0, 255, (n2, d)).astype(np.float32)
    # half of the first set are noisy copies of the second (real matches)
    pick = rng.permutation(n2)[:n1 // 2]
    d1 = np.concatenate([d2[pick] + rng.normal(0, 8, (n1 // 2, d)),
                         rng.uniform(0, 255, (n1 - n1 // 2, d))])
    m1 = rng.random(n1) < 0.9
    m2 = rng.random(n2) < 0.9
    return d1.astype(np.float32), d2, m1, m2


@pytest.mark.parametrize("ratio", [0.75, 0.95])
def test_match_l2_ratio_matches_txr(rng, ratio):
    d1, d2, m1, m2 = _descriptors(rng)
    ij, okj = j_l2(*(jnp.asarray(a) for a in (d1, d2, m1, m2)), ratio)
    i, ok = match_l2_ratio(*(torch.from_numpy(a) for a in (d1, d2, m1, m2)),
                           ratio)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(okj))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ij))
    assert ok.sum() > 50


def test_match_hamming_ratio_and_unpack_match_txr(rng):
    b2 = rng.integers(0, 256, (200, 32), dtype=np.uint8)
    flip = rng.integers(0, 256, (100, 32), dtype=np.uint8) & \
        rng.integers(0, 256, (100, 32), dtype=np.uint8) & \
        rng.integers(0, 256, (100, 32), dtype=np.uint8)
    b1 = np.concatenate([b2[:100] ^ flip,
                         rng.integers(0, 256, (120, 32), dtype=np.uint8)])
    u1, u2 = unpack_bits(torch.from_numpy(b1)), unpack_bits(
        torch.from_numpy(b2))
    np.testing.assert_array_equal(u1.numpy(),
                                  np.asarray(j_unpack(jnp.asarray(b1))))
    m1, m2 = np.ones(len(b1), bool), rng.random(len(b2)) < 0.95
    ij, okj = j_hamming(j_unpack(jnp.asarray(b1)), j_unpack(jnp.asarray(b2)),
                        jnp.asarray(m1), jnp.asarray(m2), 0.8)
    i, ok = match_hamming_ratio(u1, u2, torch.from_numpy(m1),
                                torch.from_numpy(m2), 0.8)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(okj))
    np.testing.assert_array_equal(i.numpy()[ok.numpy()],
                                  np.asarray(ij)[ok.numpy()])
    assert ok.sum() > 40


def _bgr_pair(rng):
    a = textured(rng, 96, 136)
    b = np.roll(a, 3, axis=1)                 # the view moved by 3 px
    stack = [np.stack([x, np.roll(x, 1, 0), np.roll(x, 2, 1)], -1)
             for x in (a, b)]
    return [s[:, 4:132] for s in stack]


def test_device_detector_matches_txr(rng):
    """grey -> CLAHE -> SIFT through both detectors' device backends, one
    frame at a time and batched, then ratio matching of the two frames."""
    frames = _bgr_pair(rng)
    kw = dict(n_features=200, capacity=256, backend="device")
    jd = JSIFTDetector(**kw)
    td = SIFTDetector(**kw, device="cpu")
    assert td.backend == "device" and td.use_clahe
    want = [jd.detect(f) for f in frames]
    got = td.detect_batch(frames)
    single = td.detect(torch.from_numpy(frames[1]))
    assert torch.equal(single.uv, got[1].uv)
    assert torch.equal(single.mask, got[1].mask)
    for w, g in zip(want, got):
        assert isinstance(g.uv, torch.Tensor) and g.uv.device.type == "cpu"
        m = np.asarray(w.mask)
        np.testing.assert_array_equal(g.mask.numpy(), m)
        np.testing.assert_allclose(g.uv.numpy()[m], np.asarray(w.uv)[m],
                                   atol=DETECTOR_UV_TOL)
        np.testing.assert_allclose(g.desc.numpy()[m], np.asarray(w.desc)[m],
                                   atol=DETECTOR_DESC_TOL)
        assert g.count == int(m.sum())
    uv1j, uv2j, okj = j_match_features(want[0], want[1])
    uv1, uv2, ok = match_features(got[0], got[1])
    okj = np.asarray(okj)
    np.testing.assert_array_equal(ok.numpy(), okj)
    np.testing.assert_allclose(uv2.numpy()[okj], np.asarray(uv2j)[okj],
                               atol=DETECTOR_UV_TOL)
    assert okj.sum() > 20
    # the view moved by 3 px: the matches say so
    np.testing.assert_allclose(
        np.median(uv2.numpy()[okj, 0] - uv1.numpy()[okj, 0]), 3.0, atol=0.1)


def test_cv2_backend_matches_txr(rng):
    frames = _bgr_pair(rng)
    jd = JSIFTDetector(n_features=300, capacity=512, backend="cv2")
    td = SIFTDetector(n_features=300, capacity=512, backend="cv2",
                      device="cpu")
    for f in frames:
        w, g = jd.detect(f), td.detect(f)
        np.testing.assert_array_equal(g.mask.numpy(), w.mask)
        np.testing.assert_array_equal(g.uv.numpy(), w.uv)
        np.testing.assert_array_equal(g.desc.numpy(), w.desc)
    empty = td.detect(np.zeros((64, 64), np.uint8))
    assert empty.count == 0 and empty.desc.shape == (512, 128)


def test_dedupe_matches_txr(rng):
    uv1 = rng.uniform(0, 50, (200, 2)).astype(np.float32)
    uv2 = uv1 + rng.uniform(-3, 3, (200, 2)).astype(np.float32)
    uv1[100:150] = uv1[:50] + 0.3          # near-duplicates
    uv2[100:150] = uv2[:50] + 0.3
    mask = rng.random(200) < 0.8
    want = j_dedupe(uv1, uv2, mask)
    np.testing.assert_array_equal(dedupe_matches(uv1, uv2, mask), want)
    got_t = dedupe_matches(torch.from_numpy(uv1), torch.from_numpy(uv2),
                           torch.from_numpy(mask))
    np.testing.assert_array_equal(got_t, want)
    assert not dedupe_matches(uv1, uv2, np.zeros(200, bool)).any()


def test_backend_resolution_and_device_none():
    cpu = torch.device("cpu")
    assert resolve_backend("device", cpu) == "device"
    assert resolve_backend("cv2", cpu) == "cv2"
    assert resolve_backend("auto", torch.device("cuda")) == "device"
    assert resolve_backend("auto", cpu) == "cv2"      # OpenCV is installed
    assert SIFTDetector(device="cpu").backend == "cv2"
    if torch.cuda.is_available():
        assert SIFTDetector().device.type == "cuda"
        return
    # never a silent fall-back to the CPU
    with pytest.raises(RuntimeError, match="CUDA"):
        SIFTDetector()
    with pytest.raises(RuntimeError, match="CUDA"):
        SIFTDetector(backend="cv2", device=None)


def test_auto_backend_without_opencv():
    """With OpenCV absent, 'auto' on the CPU takes the device ops, and the
    import of the features module never loads cv2."""
    code = ("import sys\n"
            "sys.modules['cv2'] = None\n"
            "import torch\n"
            "from txr_torch.geometry.features import SIFTDetector, "
            "resolve_backend\n"
            "assert resolve_backend('auto', torch.device('cpu')) == 'device'\n"
            "d = SIFTDetector(capacity=64, device='cpu')\n"
            "assert d.backend == 'device'\n"
            "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0 and "ok" in r.stdout, r.stderr


def test_features_container():
    f = Features(torch.zeros(4, 2), torch.zeros(4, 128),
                 torch.tensor([True, False, True, False]))
    assert f.count == 2 and f.kind == "sift"
    jf = JFeatures(np.zeros((4, 2)), np.zeros((4, 128)),
                   np.array([True, False, True, False]))
    assert jf.count == f.count
