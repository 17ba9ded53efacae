"""The fusion CLI's sparse stages, port against ``txr``, on the two-plane
scene that ``chip_smoke.py``'s ``sfm_path`` drives on the card (a floor and
a wall, 4 frames of 240 x 160, the camera 8 cm sideways a frame).

``txr``'s SIFT features of the frames go through both packages'
``_pairs_batch`` (match -> essential + homography RANSAC with model
selection -> pose -> refine -> triangulation), ``pair_step`` and
``_scales_batch`` (and its chunked split, ``_scales_init`` /
``_scales_views``). ``txr`` draws its RANSAC priorities from one key a
pair, split into an essential and a homography key; the port takes the
same draw through ``priorities=``.

Tolerances: the same matches, inlier counts and valid masks; R and t
within 1e-4; triangulated points within 1e-3 relative (a point's depth
amplifies the pose's round-off by depth over baseline, up to 50); scales
within 1e-5 relative on the same pair outputs, 1e-4 through each
package's own pairs.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from txr.geometry.features import SIFTDetector as JSIFTDetector
from txr.pipelines import fusion_pipeline as jfp
from txr_torch.pipelines import fusion_pipeline as tfp

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]
HYP = 128
FRAMES = 4
H, W = 240, 160


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def sfm():
    """The scene, txr's features, both packages' pair stages."""
    cs = _chip_smoke()
    s = W / cs.SFM_W
    Kt = tuple(k * s for k in cs.SFM_K)
    scene = cs.two_plane_scene(H, W, Kt, FRAMES, "cpu", seed=3,
                               blocks_per_m=cs.SFM_SCENE["blocks_per_m"] * s)
    det = JSIFTDetector(capacity=256, n_features=None, backend="device")
    feats = det.detect_batch(list(scene["bgr"].numpy()))
    desc = np.stack([np.asarray(f.desc) for f in feats])
    fmask = np.stack([np.asarray(f.mask) for f in feats])
    fuv = np.stack([np.asarray(f.uv) for f in feats])
    K = np.array([[Kt[0], 0, Kt[2]], [0, Kt[1], Kt[3]], [0, 0, 1]],
                 np.float32)
    keys = jnp.stack([jax.random.PRNGKey(10 + p) for p in range(FRAMES - 1)])
    rows = desc.shape[1]
    prio = np.stack([
        np.stack([np.asarray(jax.random.uniform(k, (HYP, rows)))
                  for k in jax.random.split(keys[p])])
        for p in range(FRAMES - 1)])
    cfg = (0.75, 3.0, 0.1, 50.0)
    want = jfp._pairs_batch(jnp.asarray(desc), jnp.asarray(fmask),
                            jnp.asarray(fuv), jnp.asarray(K), keys, *cfg,
                            num_hypotheses=HYP)
    want = [np.asarray(a) for a in want]
    got = tfp._pairs_batch(torch.from_numpy(desc), torch.from_numpy(fmask),
                           torch.from_numpy(fuv), torch.from_numpy(K), None,
                           *cfg, num_hypotheses=HYP,
                           priorities=torch.from_numpy(prio))
    return dict(cs=cs, scene=scene, K=K, prio=prio, want=want, got=got,
                depths=(scene["depth"] / cs.SFM_SCENE["depth_div"]).numpy())


def test_pairs_batch_matches_txr(sfm):
    Rj, tj, Xj, vj, nij, nmj, u1j, u2j, okj = sfm["want"]
    R, t, X, v, ni, nm, u1, u2, ok = (a.numpy() for a in sfm["got"])
    np.testing.assert_array_equal(ok, okj)
    np.testing.assert_array_equal(nm, nmj)
    np.testing.assert_array_equal(ni, nij)
    np.testing.assert_array_equal(v, vj)
    np.testing.assert_array_equal(u1, u1j)
    np.testing.assert_array_equal(u2[ok], u2j[okj])
    np.testing.assert_allclose(R, Rj, atol=1e-4)
    np.testing.assert_allclose(t, tj, atol=1e-4)
    np.testing.assert_allclose(X[v], Xj[vj], rtol=1e-3, atol=1e-3)
    assert (X[~v] == 0).all()
    assert v.sum(-1).min() > 30 and nm.min() > 50


def test_pair_step_matches_txr(sfm):
    """pair_step on pair 1's rows with its draw, against txr's pair 1."""
    _, _, _, _, _, _, u1, u2, ok = sfm["want"]
    out = tfp.pair_step(torch.from_numpy(u1[1]), torch.from_numpy(u2[1]),
                        torch.from_numpy(ok[1]), torch.from_numpy(sfm["K"]),
                        None, 3.0, 0.1, 50.0, num_hypotheses=HYP,
                        priorities=tuple(torch.from_numpy(sfm["prio"][1])))
    Rj, tj, Xj, vj, nij = (a[1] for a in sfm["want"][:5])
    R, t, X, v, ni = (a.numpy() for a in out)
    np.testing.assert_allclose(R, Rj, atol=1e-4)
    np.testing.assert_allclose(t, tj, atol=1e-4)
    np.testing.assert_array_equal(v, vj)
    assert int(ni) == int(nij)


def test_pairs_against_the_scene(sfm):
    """A loose sanity bound on the scene itself: rotation within 1 degree.
    (At 160 px wide the parallax is 5 to 14 px and t is only good to about
    10 degrees; chip_smoke.py holds the 1080 x 1920 run to the truth.)"""
    cs = sfm["cs"]
    R_true, _ = cs.relative_truth(sfm["scene"]["R"], sfm["scene"]["t"])
    R = sfm["got"][0].numpy()
    for p in range(FRAMES - 1):
        assert cs.angle_deg(R[p], R_true[p]) < 1.0


def _chain(sfm):
    Rj, tj, _, _, nij, nmj = sfm["want"][:6]
    return sfm["cs"].chain_views(Rj, tj, nmj, nij)


@pytest.mark.parametrize("inputs", ["same", "own"])
def test_scales_batch_matches_txr(sfm, inputs):
    """On txr's pair outputs ("same") the scales agree to 1e-5 relative; on
    each package's own pair outputs ("own", the whole sparse path) to 1e-4:
    the median takes one point, whose depth carries the pose's round-off
    (1e-5 of a depth of up to 50 baselines)."""
    R_prev, t_prev, processed = _chain(sfm)
    assert processed == list(range(2, FRAMES))
    _, _, Xj, vj, _, _, u1j, u2j, _ = sfm["want"]
    want = jfp._scales_batch(*(jnp.asarray(a) for a in (
        Xj, vj, u1j, u2j, sfm["depths"], R_prev, t_prev)))
    if inputs == "same":
        X, v, u1, u2 = (torch.from_numpy(a) for a in (Xj, vj, u1j, u2j))
        rtol = 1e-5
    else:
        _, _, X, v, _, _, u1, u2, _ = sfm["got"]
        rtol = 1e-4
    got = tfp._scales_batch(X, v, u1, u2, torch.from_numpy(sfm["depths"]),
                            torch.from_numpy(R_prev),
                            torch.from_numpy(t_prev))
    s1j, s2j, n0j, swj, oknj = (np.asarray(a) for a in want)
    s1, s2, n0, sw, okn = (a.numpy() for a in got)
    np.testing.assert_allclose([s1, s2], [s1j, s2j], rtol=rtol)
    np.testing.assert_allclose(sw, swj, rtol=rtol)
    assert int(n0) == int(n0j)
    np.testing.assert_array_equal(okn, oknj)
    truth = sfm["cs"].SFM_SCENE["depth_div"] / sfm["cs"].SFM_SCENE["baseline"]
    assert abs(float(s1) / truth - 1) < 0.1


def test_scales_split_matches_txr(sfm):
    """The chunked-sequence split: init-pair scales and per-view scales."""
    R_prev, t_prev, _ = _chain(sfm)
    _, _, Xj, vj, _, _, u1j, u2j, _ = sfm["want"]
    d = sfm["depths"]
    want = jfp._scales_init(*(jnp.asarray(a) for a in (
        Xj[0], vj[0], u1j[0], u2j[0], d[0], d[1])))
    got = tfp._scales_init(*(torch.from_numpy(np.ascontiguousarray(a)) for a
                             in (Xj[0], vj[0], u1j[0], u2j[0], d[0], d[1])))
    np.testing.assert_allclose([float(a) for a in got[:2]],
                               [float(a) for a in want[:2]], rtol=1e-5)
    assert int(got[2]) == int(want[2])
    want = jfp._scales_views(*(jnp.asarray(a) for a in (
        Xj, vj, u2j, R_prev, t_prev, d[1:])))
    got = tfp._scales_views(*(torch.from_numpy(np.ascontiguousarray(a)) for a
                              in (Xj, vj, u2j, R_prev, t_prev, d[1:])))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    Xw, okw = tfp.sparse_to_world(*(torch.from_numpy(a) for a in (
        Xj[1], vj[1], R_prev[1], t_prev[1])))
    Xwj, okwj = jfp.sparse_to_world(*(jnp.asarray(a) for a in (
        Xj[1], vj[1], R_prev[1], t_prev[1])))
    np.testing.assert_allclose(Xw.numpy(), np.asarray(Xwj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(okw.numpy(), np.asarray(okwj))


def test_pair_cap_compaction_keeps_order(monkeypatch):
    """TXR_PAIR_CAP keeps the matched rows first, each group in its order,
    as txr's stable top-k of the match mask does."""
    ok = np.random.default_rng(4).random(300) < 0.3
    want = np.asarray(jax.lax.top_k(jnp.asarray(ok, jnp.int32), 128)[1])
    got = tfp._compact(torch.from_numpy(ok), 128).numpy()
    np.testing.assert_array_equal(got, want)
    assert tfp._pad_pow2(5) == jfp._pad_pow2(5) == 8
    assert tfp._pad_pow2(0, lo=2) == jfp._pad_pow2(0, lo=2)
    monkeypatch.setenv("TXR_SEQ_CHUNK", "48")
    assert tfp._seq_chunk() == jfp._seq_chunk() == 64


def test_pairs_batch_with_a_generator_and_a_small_cap(sfm, monkeypatch):
    """Drawn from a generator, the run repeats with the same seed; with
    TXR_PAIR_CAP below the capacity the pairs run on the first matched
    rows."""
    _, _, _, _, _, _, u1j, _, okj = sfm["want"]
    feats = JSIFTDetector(capacity=256, n_features=None,
                          backend="device").detect_batch(
        list(sfm["scene"]["bgr"].numpy()[:2]))
    args = [torch.from_numpy(np.stack([np.asarray(getattr(f, k))
                                       for f in feats]))
            for k in ("desc", "mask", "uv")]
    K = torch.from_numpy(sfm["K"])
    run = [tfp._pairs_batch(*args, K, torch.Generator().manual_seed(5),
                            0.75, 3.0, 0.1, 50.0, num_hypotheses=HYP)
           for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*run))
    monkeypatch.setenv("TXR_PAIR_CAP", "64")
    small = tfp._pairs_batch(*args, K, torch.Generator().manual_seed(5),
                             0.75, 3.0, 0.1, 50.0, num_hypotheses=HYP)
    assert small[6].shape == (1, 64, 2) and bool(small[8].all())
    np.testing.assert_array_equal(small[6][0].numpy(),
                                  u1j[0][okj[0]][:64])
