"""The port's TF1 checkpoint bridge (``evaluation/tf_checkpoint.py``) against
the JAX package's: the same bytes written, each package reading the other's
files, and the scope mapping giving the JAX mapping's parameters
(``params_from_jax``) bit for bit. Everything here is exact: the reader,
writer and crc are the same pure Python, the tensors float32 copies."""

import jax
import numpy as np
import pytest
import torch

from facet_graph_convolution_tpu.evaluation import tf_checkpoint as jax_ckpt
from facet_graph_convolution_tpu.models.unet import init_unet as jax_init_unet
from facet_graph_convolution_torch.evaluation.tf_checkpoint import (
    crc32c,
    export_unet_to_tf,
    load_reference_unet,
    map_reference_tensors,
    masked_crc32c,
    read_sstable,
    read_tf_checkpoint,
    write_sstable,
    write_tf_checkpoint,
)
from facet_graph_convolution_torch.models.unet import init_unet
from facet_graph_convolution_torch.params import params_from_jax
from tests.test_tf_checkpoint import _reference_named_tensors

FALLBACK = {  # graphs recorded without name-scope uniquification
    "Level1_1/Conv": "Level1/Conv_2", "Level1_1/Conv_1": "Level1/Conv_3",
    "Level0_1/Conv": "Level0/Conv_2", "Level0_1/Conv_1": "Level0/Conv_3",
    "Level1_1/MLP": "Level1/MLP", "Level1_1/MLP_1": "Level1/MLP_1",
    "Level0_1/MLP": "Level0/MLP", "Level0_1/MLP_1": "Level0/MLP_1",
}


def _files(prefix):
    return [prefix + ".index", prefix + ".data-00000-of-00001"]


def _bytes(path):
    with open(path, "rb") as fh:
        return fh.read()


def test_crc32c_known_vectors():
    # RFC 3720 / iSCSI vectors of the Castagnoli polynomial
    assert crc32c(b"") == 0
    assert crc32c(b"123456789") == 0xE3069283
    assert crc32c(bytes(32)) == 0x8A9136AA
    assert masked_crc32c(b"123456789") == (
        (((0xE3069283 >> 15) | (0xE3069283 << 17)) + 0xA282EAD8) & 0xFFFFFFFF)
    data = bytes(range(256)) * 3
    assert crc32c(data) == jax_ckpt.crc32c(data)


def test_sstable_bytes_match_jax(tmp_path):
    pairs = {b"": b"header-bytes", b"alpha/weight": b"A" * 100,
             b"alpha/weight/extra": b"B", b"zeta": b""}
    ours, theirs = str(tmp_path / "a.index"), str(tmp_path / "b.index")
    write_sstable(ours, pairs)
    jax_ckpt.write_sstable(theirs, pairs)
    assert _bytes(ours) == _bytes(theirs)
    assert read_sstable(theirs) == pairs


def test_checkpoint_bytes_match_and_cross_read(tmp_path, rng):
    tensors = {
        "Level0/Conv/weight": rng.normal(size=(9, 32, 6)).astype(np.float32),
        "Level0/Conv/bias": rng.normal(size=(32,)).astype(np.float32),
        "scalar": np.float32(3.5).reshape(()),
        "ints": np.arange(7, dtype=np.int64),
        "flags": np.array([True, False]),
    }
    ours, theirs = str(tmp_path / "port" / "net-100"), str(tmp_path / "jax" / "net-100")
    write_tf_checkpoint(ours, tensors)
    jax_ckpt.write_tf_checkpoint(theirs, tensors)
    for a, b in zip(_files(ours), _files(theirs)):
        assert _bytes(a) == _bytes(b), a
    for reader, prefix in ((read_tf_checkpoint, theirs), (jax_ckpt.read_tf_checkpoint, ours)):
        back = reader(prefix)
        assert set(back) == set(tensors)
        for k in tensors:
            assert back[k].dtype == tensors[k].dtype
            np.testing.assert_array_equal(back[k], tensors[k])


@pytest.mark.parametrize("form", ["single-scale", "multi-scale", "fallback names"])
def test_map_reference_tensors_matches_jax(rng, form):
    tensors = _reference_named_tensors(rng, multi_scale=form != "single-scale")
    if form == "fallback names":
        tensors = {f"{FALLBACK.get(k.rsplit('/', 1)[0], k.rsplit('/', 1)[0])}/"
                   f"{k.rsplit('/', 1)[1]}": v for k, v in tensors.items()}
    params, multi = map_reference_tensors(tensors, device="cpu")
    jparams, jmulti = jax_ckpt.map_reference_tensors(tensors)
    want = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    assert multi == jmulti == (form != "single-scale")
    assert params.keys() == want.keys()
    for layer in want:
        assert params[layer].keys() == want[layer].keys()
        for name, t in want[layer].items():
            got = params[layer][name]
            assert got.dtype == torch.float32 and got.device.type == "cpu"
            assert torch.equal(got, t), (layer, name)


def test_map_reference_tensors_names_the_missing_variable(rng):
    tensors = _reference_named_tensors(rng)
    del tensors["Level1_1/Conv_1/weight"]
    with pytest.raises(KeyError, match="dconv2"):
        map_reference_tensors(tensors, device="cpu")
    tensors = _reference_named_tensors(rng, multi_scale=True)
    del tensors["Level1_1/MLP/weight"]
    with pytest.raises(KeyError, match="fc_mid"):
        map_reference_tensors(tensors, device="cpu")


def test_map_reference_tensors_needs_a_card_unless_cpu(rng, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        map_reference_tensors(_reference_named_tensors(rng))


@pytest.mark.parametrize("multi_scale", [False, True])
def test_export_unet_to_tf_matches_jax_bytes_and_round_trips(tmp_path, multi_scale):
    small = dict(channels=(8, 16, 32), num_filters=4, fc_channels=32, multi_scale=multi_scale)
    jparams = jax.tree.map(np.asarray, jax_init_unet(jax.random.PRNGKey(0), **small))
    ours, theirs = str(tmp_path / "port" / "net-1"), str(tmp_path / "jax" / "net-1")
    export_unet_to_tf(ours, params_from_jax(jparams, device="cpu"))
    jax_ckpt.export_unet_to_tf(theirs, jparams)
    for a, b in zip(_files(ours), _files(theirs)):
        assert _bytes(a) == _bytes(b), a

    params = init_unet(0, device="cpu", **small)
    export_unet_to_tf(ours, params)
    back, multi = load_reference_unet(ours, device="cpu")
    assert multi == multi_scale and back.keys() == params.keys()
    for layer in params:
        for name, t in params[layer].items():
            assert torch.equal(back[layer][name], t), (layer, name)
