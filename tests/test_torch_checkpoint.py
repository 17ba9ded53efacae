"""Checkpoint files through both packages: a vits-scale Hugging Face state
dict, synthesised as ``tests/test_checkpoint_smoke.py`` does (no weights can
be downloaded), written as ``.safetensors`` and ``.pth`` in HF and in
original Depth-Anything naming, loaded by ``txr``'s and by the port's
``DepthAnythingModel(checkpoint_path=...)`` and run on one small image.
"""

import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

pytest.importorskip("safetensors")
pytest.importorskip("transformers")

from txr.models.depth_anything import DepthAnythingModel as TxrModel

from txr_torch.models import checkpoint as pck
from txr_torch.models.convert import convert_state_dict
from txr_torch.models.depth_anything import DepthAnythingModel

sys.path.insert(0, os.path.dirname(__file__))
from test_checkpoint_smoke import (VITS, _make_vits_hf_state_dict,  # noqa: E402
                                   _to_original_naming)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def vits_sd():
    sd = _make_vits_hf_state_dict(seed=0)
    # keep the relative head's final ReLU from saturating to zeros
    sd["head.conv3.bias"] = sd["head.conv3.bias"] + 1.0
    return sd


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(0).integers(0, 255, (96, 128, 3), np.uint8)


def _write(sd, path):
    if str(path).endswith(".safetensors"):
        from safetensors.numpy import save_file

        save_file(sd, str(path))
    else:
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, str(path))


def _port(path):
    return DepthAnythingModel(version="v2", encoder="vits",
                              checkpoint_path=str(path), input_size=140,
                              param_dtype=torch.float32, device="cpu")


@pytest.mark.parametrize("naming", ["hf", "original"])
@pytest.mark.parametrize("ext", [".safetensors", ".pth"])
def test_checkpoint_file_infers_like_txr(vits_sd, image, tmp_path, ext,
                                         naming, monkeypatch):
    """1e-4 of the depth's span at f32: one weight file, two loaders, two
    frameworks summing in another order."""
    sd = vits_sd if naming == "hf" else _to_original_naming(vits_sd,
                                                            VITS["layers"])
    ckpt = tmp_path / f"da_{naming}{ext}"
    _write(sd, ckpt)
    monkeypatch.setenv("TXR_CKPT_CACHE", str(tmp_path / "cache"))
    want = TxrModel(version="v2", encoder="vits", checkpoint_path=str(ckpt),
                    input_size=140, param_dtype=jnp.float32).infer(image)
    got = _port(ckpt).infer(image)
    assert got.shape == (96, 128) and np.isfinite(got).all()
    span = float(want.max() - want.min())
    assert span > 0, "checkpoint weights ignored: output degenerate"
    assert np.abs(got - want).max() <= 1e-4 * span


def test_wrapped_state_dicts_unwrap(vits_sd, tmp_path, image):
    """torch.save files that wrap the weights under state_dict / model."""
    tensors = {k: torch.from_numpy(v) for k, v in vits_sd.items()}
    torch.save(tensors, str(tmp_path / "plain.pt"))
    torch.save({"state_dict": tensors}, str(tmp_path / "sd.bin"))
    torch.save({"model": tensors, "epoch": 3}, str(tmp_path / "model.pth"))
    want = pck.read_state_dict(str(tmp_path / "plain.pt"))
    for name in ("sd.bin", "model.pth"):
        got = pck.read_state_dict(str(tmp_path / name))
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in want)


def test_map_drops_dead_weights_and_fuses_qkv(vits_sd):
    sd = {k: torch.from_numpy(v) for k, v in vits_sd.items()}
    out = convert_state_dict(sd, VITS["layers"])
    assert not any(k.startswith("head.fusion_3.rcu1") for k in out)
    assert "head.fusion_2.rcu1.conv1.weight" in out
    # HF fusion layer 0 is the deepest stage, fusion_3 here
    assert torch.equal(out["head.fusion_3.project.weight"],
                       sd["neck.fusion_stage.layers.0.projection.weight"])
    b = "backbone.encoder.layer.2.attention.attention."
    qkv = out["encoder.block_2.attn.qkv.weight"]
    h = VITS["hidden"]
    assert qkv.shape == (3 * h, h)
    assert torch.equal(qkv[h:2 * h], sd[b + "key.weight"])
    # transposed-conv kernels are PyTorch's already: no flip
    assert torch.equal(out["head.resize_0.weight"],
                       sd["neck.reassemble_stage.layers.0.resize.weight"])
    model = _port_model_keys()
    assert set(out) == model


def _port_model_keys():
    from txr_torch.models.depth_anything import build_model

    model, _, _ = build_model("v2", "vits", device="cpu")
    return set(model.state_dict())


def test_missing_tensor_raises(vits_sd):
    sd = {k: torch.from_numpy(v) for k, v in vits_sd.items()
          if k != "head.conv2.bias"}
    with pytest.raises(KeyError):
        convert_state_dict(sd, VITS["layers"])


def test_save_params_round_trip(vits_sd, tmp_path, image):
    """save_params -> directory -> checkpoint_path=directory."""
    ckpt = tmp_path / "hf.safetensors"
    _write(vits_sd, ckpt)
    first = _port(ckpt)
    out_dir = tmp_path / "native"
    pck.save_params(str(out_dir), first.model.state_dict())
    assert os.path.isfile(out_dir / pck.PARAMS_FILE)
    loaded = pck.load_params(str(out_dir))
    sd = first.model.state_dict()
    assert loaded.keys() == sd.keys()
    assert all(torch.equal(loaded[k], sd[k]) for k in sd)
    second = _port(out_dir)
    np.testing.assert_array_equal(second.infer(image), first.infer(image))


def test_safetensors_is_imported_only_when_such_a_file_is_read():
    import subprocess

    code = ("import sys, txr_torch.models.checkpoint, "
            "txr_torch.models.depth_anything\n"
            "assert 'safetensors' not in sys.modules\n"
            "assert 'transformers' not in sys.modules\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       env=dict(os.environ, PYTHONPATH=root),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
