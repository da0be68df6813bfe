"""PyTorch port vs JAX package: cellpose's CPnet (``segmentation.
cellpose_net``).

The randomized cellpose 2.x replica of ``tests/test_cellpose_net.py``
(cellpose's module names, every parameter and BatchNorm statistic drawn)
loads strictly into the port's ``CPnet``; its forward equals the replica's
and JAX's ``cpnet_apply`` on the converted weights at rtol / atol 1e-4; a
drifted key or shape raises an error naming it.  The JAX parameter pytree
crosses over by ``convert.cpnet_from_params``.  The 3D driver equals JAX's
at the same tolerance, whatever its chunk size, and its labels equal
JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageanalysis3_tpu.segmentation import cellpose_net as JC
from imageanalysis3_tpu_torch.convert import cpnet_from_params
from imageanalysis3_tpu_torch.segmentation import cellpose_net as TC
from test_cellpose_net import NBASE, _randomized_net

torch.set_num_threads(2)
CPU = "cpu"


def _nets(seed=0):
    """(replica, the port's CPnet from its state_dict, JAX's pytree)."""
    net = _randomized_net(NBASE, seed=seed)
    sd = net.state_dict()
    return (net, TC.convert_cellpose_state_dict(sd, nbase=NBASE, device=CPU),
            JC.convert_cellpose_state_dict(sd, nbase=NBASE))


def test_replica_loads_strictly_and_matches_jax():
    net, port, params = _nets()
    assert set(port.state_dict()) == set(net.state_dict())
    im = np.random.default_rng(1).normal(0, 1, (2, 32, 48)).astype(
        np.float32)
    with torch.no_grad():
        ref = net(torch.from_numpy(im)[None])[0].numpy()
    flow, prob = TC.cpnet_apply(port, im)
    want_f, want_p = JC.cpnet_apply(params, im)
    for got, want in ((flow, ref[:2]), (prob, ref[2]),
                      (flow, np.asarray(want_f)), (prob, np.asarray(want_p))):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    # the JAX pytree carried across
    again = cpnet_from_params(jax.tree_util.tree_map(np.asarray, params),
                              device=CPU)
    f2, p2 = TC.cpnet_apply(again, im)
    assert torch.equal(f2, flow) and torch.equal(p2, prob)


def test_convert_rejects_shape_and_key_drift():
    net = _randomized_net(NBASE)
    sd = dict(net.state_dict())
    bad = dict(sd)
    bad["output.2.weight"] = torch.zeros(4, 8, 1, 1)
    with pytest.raises(ValueError, match="output.2.weight"):
        TC.convert_cellpose_state_dict(bad, nbase=NBASE, device=CPU)
    missing = {k: v for k, v in sd.items()
               if k != "downsample.down.res_down_0.proj.1.bias"}
    with pytest.raises(KeyError, match="res_down_0.proj.1.bias"):
        TC.convert_cellpose_state_dict(missing, nbase=NBASE, device=CPU)
    extra = dict(sd, **{"upsample.up.res_up_0.conv.conv_4.full.bias":
                        torch.zeros(8)})
    with pytest.raises(KeyError, match="conv_4.full.bias"):
        TC.convert_cellpose_state_dict(extra, nbase=NBASE, device=CPU)
    with pytest.raises(ValueError, match="res_down_0"):
        TC.convert_cellpose_state_dict(sd, nbase=[2, 16, 16, 32],
                                       device=CPU)
    # cellpose's extra buffers are ignored, NumPy arrays are taken
    loose = {k: v.numpy() for k, v in sd.items()
             if not k.endswith("num_batches_tracked")}
    loose["diam_mean"] = np.array([17.0], np.float32)
    loose["diam_labels"] = np.array([17.0], np.float32)
    port = TC.convert_cellpose_state_dict(loose, nbase=NBASE, device=CPU)
    for k, v in port.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, sd[k]), k


def test_load_cellpose_checkpoint(tmp_path):
    net = _randomized_net(NBASE, seed=2)
    im = np.random.default_rng(3).normal(0, 1, (2, 16, 24)).astype(
        np.float32)
    with torch.no_grad():
        ref = net(torch.from_numpy(im)[None])[0].numpy()
    for name, obj in (("plain.pt", net.state_dict()),
                      ("wrapped.pt", {"state_dict": net.state_dict()})):
        torch.save(obj, tmp_path / name)
        port = TC.load_cellpose_checkpoint(str(tmp_path / name),
                                           nbase=NBASE, device=CPU)
        flow, prob = TC.cpnet_apply(port, im)
        np.testing.assert_allclose(flow.numpy(), ref[:2], rtol=1e-4,
                                   atol=1e-4)


def test_cellpose_3d_driver_matches_jax(monkeypatch):
    _, port, params = _nets(seed=3)
    rng = np.random.default_rng(2)
    vol = rng.uniform(0, 1000, (2, 8, 16, 24)).astype(np.float32)
    # the percentiles interpolate in float32 as jnp.percentile does, one
    # rounding apart where XLA fuses the product and the sum
    np.testing.assert_allclose(
        TC._normalize99(torch.from_numpy(vol)).numpy(),
        np.asarray(JC._normalize99(jnp.asarray(vol))), rtol=1e-6, atol=1e-7)
    want_f, want_p = JC.cellpose_flows_3d(params, vol)
    for chunk in (TC.CHUNK_PX, 1, 200):
        monkeypatch.setattr(TC, "CHUNK_PX", chunk)
        flow, prob = TC.cellpose_flows_3d(port, vol)
        assert flow.shape == (3, 8, 16, 24) and prob.shape == (8, 16, 24)
        np.testing.assert_allclose(flow.numpy(), np.asarray(want_f),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(prob.numpy(), np.asarray(want_p),
                                   rtol=1e-4, atol=1e-4)
    kw = dict(max_cells=8, min_count=1, bin_zxy=(2, 2, 2))
    want = np.asarray(JC.segment_cells_cellpose(vol, params, **kw))
    got = TC.segment_cells_cellpose(vol, port, **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_pad_to_cpnet_matches_jax():
    im = np.random.default_rng(4).normal(size=(2, 13, 22)).astype(
        np.float32)
    want, pads = JC.pad_to_cpnet(im, 4)
    got, got_pads = TC.pad_to_cpnet(im, 4)
    assert got_pads == pads == (3, 2)
    np.testing.assert_array_equal(got, want)
    same, none = TC.pad_to_cpnet(want, 4)
    assert none == (0, 0) and same is want


def test_converter_needs_a_card_without_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    net = _randomized_net(NBASE)
    with pytest.raises(RuntimeError, match="CUDA"):
        TC.convert_cellpose_state_dict(net.state_dict(), nbase=NBASE)
