"""The port's fused stream against ``txr``'s on the CPU: the per-frame fused
run (``stream_batch=1``) and the batched one (B = 3 over 5 frames, so the
padded tail runs), on ``tests/test_stream_step.py``'s frames, settings and
tiny model (carried into the port in f32, see
``test_torch_stream_step.py``). The port gets ``txr``'s key stream through
``priorities=`` (``test_torch_streaming.TxrDraws``: one split per
non-initial frame, as ``txr``'s step splits its state key).

Bounds are ``txr``'s own for its fused tests (``tests/test_stream_step.py``):
fused against fused and batched against batched, R within 5e-3 and t
within 2e-2, the map size within max(2, size / 20); the port's batched run
against its per-frame run, R 5e-2 and t 8e-2, the map size within max(5,
size / 10) (ICP registers against the batch-start map there). Measured
worst cases: beside each bound below.
"""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from test_torch_stream_step import (H, W, ListSource, port_run,  # noqa: E402
                                    shifted_frames, tiny_models)
from test_torch_streaming import TxrDraws  # noqa: E402
from txr.core.config import StreamingConfig as JConfig  # noqa: E402
from txr.core.intrinsics import CameraIntrinsics as JIntr  # noqa: E402
from txr.fusion.offset_map import offset_map_size as j_size  # noqa: E402
from txr.pipelines.streaming import \
    StreamingReconstructor as JRec  # noqa: E402
from txr_torch.fusion.offset_map import offset_map_size  # noqa: E402

# (R, t) bounds and their measured worst cases on these frames
FUSED_TOL = (5e-3, 2e-2)       # measured: 7.4e-5, 3.4e-3 (both runs)
BATCHED_TOL = (5e-2, 8e-2)     # measured: 0.0, 0.0


@pytest.fixture(scope="module")
def runs():
    jm, pm = tiny_models()
    frames = shifted_frames()
    out = {}
    for batch in (1, 3):
        jrec = JRec(JIntr(130.0, 130.0, W / 2, H / 2, W, H), depth_model=jm,
                    config=JConfig(voxel_size=0.02, max_map_points=1 << 14,
                                   subsample_factor=2, max_depth=1e6,
                                   min_depth=1e-6, loop_closure=False,
                                   stream_batch=batch),
                    use_icp=True, metric_depth=True, verbose=False,
                    fused=True, feature_capacity=1024, icp_sample=512)
        jrec.run(ListSource(frames))
        trec = port_run(pm, frames, True, stream_batch=batch,
                        priorities=TxrDraws())
        out[batch] = (jrec, trec)
    return out


def assert_close_streams(got, want, tol, size_slack):
    assert got.frames_processed == want.frames_processed == 5
    assert got.frames_skipped == want.frames_skipped == 0
    assert len(got.poses) == len(want.poses)
    for k, ((Rg, tg), (Rw, tw)) in enumerate(zip(got.poses, want.poses)):
        np.testing.assert_allclose(Rg, np.asarray(Rw), atol=tol[0],
                                   err_msg=str(k))
        np.testing.assert_allclose(tg, np.asarray(tw), atol=tol[1],
                                   err_msg=str(k))
    n_got, n_want = size_of(got), size_of(want)
    assert n_got > 100
    assert abs(n_got - n_want) <= size_slack(n_want)


def size_of(rec):
    try:
        return int(offset_map_size(rec.map))
    except AttributeError:
        return int(j_size(rec.map))


@pytest.mark.parametrize("batch", [1, 3])
def test_fused_run_matches_txr(runs, batch):
    jrec, trec = runs[batch]
    assert trec.route == ("fused_per_frame" if batch == 1
                          else "fused_batched")
    assert_close_streams(trec, jrec, FUSED_TOL, lambda n: max(2, n // 20))


def test_batched_matches_per_frame(runs):
    """The port's batched run (the padded tail included) against its own
    per-frame run, at txr's bounds for the same comparison."""
    assert_close_streams(runs[3][1], runs[1][1], BATCHED_TOL,
                         lambda n: max(5, n // 10))
    # one host read per batch; per frame, after frame 1 and at the end
    assert runs[3][1].drains == 2 and runs[1][1].drains == 2
