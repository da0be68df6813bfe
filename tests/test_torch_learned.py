"""PyTorch port vs JAX package: the learned segmenter
(``segmentation.learned``).

On the JAX package's weights carried over by ``convert.unet_from_params``:
``unet_apply`` at rtol / atol 1e-4, also where a pooled size is odd (there
``F.interpolate(mode="nearest")`` picks other rows than
``jax.image.resize(..., "nearest")``; ``nearest-exact`` picks JAX's);
``follow_flows`` at atol 1e-5; ``masks_from_flows`` labels equal (its
coarse propagation capped at ``merge_iters``); ``labels_to_flows`` exact;
``unet_loss`` at rtol 1e-5 and its gradients at rtol 1e-4 with atol 1e-4 x
the gradient's largest magnitude (over all parameters: a bias before an
instance norm has a gradient of rounding noise only); the port's Adam
step, fed JAX's gradients, equal to optax's update at rtol 1e-6.  Training
cannot be bit-equal across packages, so the port's ``fit_unet`` is held to
the JAX tests' own IoU bars on their scenes, from the JAX initialisation.
Weights cross between the packages' ``.npz`` files both ways.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from imageanalysis3_tpu.segmentation import learned as JL
from imageanalysis3_tpu_torch.convert import unet_from_params
from imageanalysis3_tpu_torch.segmentation import learned as TL

torch.set_num_threads(4)
CPU = "cpu"


def _port(params):
    return unet_from_params(jax.tree_util.tree_map(np.asarray, params),
                            device=CPU)


def _ellipsoid_mask(shape, center, radii):
    zz, xx, yy = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    return ((((zz - center[0]) / radii[0]) ** 2
             + ((xx - center[1]) / radii[1]) ** 2
             + ((yy - center[2]) / radii[2]) ** 2) <= 1.0)


def _two_cell_labels(shape=(8, 48, 48)):
    truth = np.zeros(shape, np.int32)
    truth[_ellipsoid_mask(shape, (4, 16, 22), (3, 10, 10))] = 1
    truth[_ellipsoid_mask(shape, (4, 32, 26), (3, 10, 10))] = 2
    return truth


def _iou(a, b):
    return (a & b).sum() / max((a | b).sum(), 1)


def _per_cell_iou(labels, truth):
    return [max(_iou(labels == l, truth == t)
                for l in range(1, labels.max() + 1))
            for t in range(1, truth.max() + 1)]


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("case", [(2, 8, 2, (6, 50, 46)),
                                  (2, 4, 3, (3, 22, 26))])
def test_unet_apply_matches_jax(case):
    c, base, levels, shape = case
    params = JL.init_unet_params(jax.random.PRNGKey(0), in_channels=c,
                                 base=base, levels=levels)
    im = np.random.default_rng(0).normal(size=(c,) + shape).astype(
        np.float32)
    want_f, want_l = JL.unet_apply(params, jnp.asarray(im))
    with torch.no_grad():
        got_f, got_l = TL.unet_apply(_port(params), im)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("sizes", [(13, 25), (12, 23), (26, 51), (3, 5)])
def test_nearest_exact_is_jax_nearest(sizes):
    """The decoder's resize: ``nearest-exact`` equals JAX's ``nearest`` at
    the sizes a pooled odd axis gives (ceil(n / 2) -> n); ``nearest``
    does not."""
    n_in, n_out = sizes
    x = np.arange(n_in, dtype=np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (n_out,), "nearest"))
    t = torch.from_numpy(x)[None, None]
    exact = F.interpolate(t, size=n_out, mode="nearest-exact")[0, 0]
    plain = F.interpolate(t, size=n_out, mode="nearest")[0, 0]
    np.testing.assert_array_equal(exact.numpy(), want)
    assert (plain.numpy() != want).any()


def test_follow_flows_and_masks_match_jax():
    truth = _two_cell_labels()
    flow_t, fg = JL.labels_to_flows(truth)
    got_flow, got_fg = TL.labels_to_flows(torch.from_numpy(truth))
    np.testing.assert_array_equal(got_flow, flow_t)
    np.testing.assert_array_equal(got_fg, fg)
    # a smooth perturbation, as a trained network's flows are smooth (a
    # per-voxel random field amplifies rounding over 40 steps)
    zz, xx, yy = np.meshgrid(*[np.arange(s) for s in truth.shape],
                             indexing="ij")
    wave = np.stack([np.sin(xx / 5.0 + yy / 7.0), np.cos(zz / 3.0 + yy / 6.0),
                     np.sin(xx / 4.0 - zz / 5.0)])
    flow = (flow_t + 0.3 * wave).astype(np.float32)
    for fl in (flow_t, flow):
        want = np.asarray(JL.follow_flows(jnp.asarray(fl), jnp.asarray(fg),
                                          n_iters=40))
        got = TL.follow_flows(fl, fg, n_iters=40, device=CPU)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    for fl in (flow_t, flow):
        prob = np.where(fg, 5.0, -5.0).astype(np.float32)
        for kw in (dict(max_cells=8, min_count=10),
                   dict(max_cells=3, min_count=1, merge_iters=2,
                        bin_zxy=(1, 2, 2))):
            want = np.asarray(JL.masks_from_flows(
                jnp.asarray(fl), jnp.asarray(prob), **kw))
            got = TL.masks_from_flows(fl, prob, device=CPU, **kw)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)
            assert want.max() >= 2


def test_masks_from_flows_ties_rank_lower_index_first():
    """Equal peak scores (a flat landing grid with no ramp breaking the
    tie at the cap) are ranked lower index first, as lax.top_k ranks."""
    shape = (4, 16, 16)
    flow = np.zeros((3,) + shape, np.float32)
    prob = np.full(shape, 1.0, np.float32)
    for kw in (dict(max_cells=2, min_count=1, bin_zxy=(2, 4, 4)),
               dict(max_cells=5, min_count=1, bin_zxy=(1, 1, 1))):
        want = np.asarray(JL.masks_from_flows(jnp.asarray(flow),
                                              jnp.asarray(prob), **kw))
        got = TL.masks_from_flows(flow, prob, device=CPU, **kw)
        np.testing.assert_array_equal(got.numpy(), want)


def _train_scene():
    truth = _two_cell_labels()
    rng = np.random.default_rng(2)
    im = (truth > 0).astype(np.float32) * 900.0 + 100.0
    im = (im + rng.normal(0, 30.0, im.shape).astype(np.float32))[None]
    return im, truth


def _jax_gates(params, im):
    """The pre-ReLU activations of JAX's ``unet_apply`` (its own pieces, in
    its order), each (Z, X, Y, C)."""
    x = jnp.moveaxis(jnp.asarray(im, jnp.float32), 0, -1)
    x = (x - x.mean()) / (x.std() + 1e-6)
    gates, skips = [], []
    for i, lvl in enumerate(params["enc"]):
        for k in ("a", "b"):
            gates.append(JL._norm(JL._conv(lvl[k], x)))
            x = jax.nn.relu(gates[-1])
        if i < len(params["enc"]) - 1:
            skips.append(x)
            x = jax.lax.reduce_window(x, -jnp.inf, jax.lax.max,
                                      (1, 2, 2, 1), (1, 2, 2, 1), "SAME")
    for lvl in params["dec"]:
        skip = skips.pop()
        x = jax.image.resize(x, skip.shape[:3] + (x.shape[-1],), "nearest")
        x = jnp.concatenate([x, skip], axis=-1)
        for k in ("a", "b"):
            gates.append(JL._norm(JL._conv(lvl[k], x)))
            x = jax.nn.relu(gates[-1])
    return [np.asarray(g) for g in gates]


def _port_gates(net, im, dtype=torch.float32):
    """The same pre-ReLU activations of the port's ``UNet3D`` (as
    (Z, X, Y, C)), in `dtype`."""
    net = net.to(dtype)
    x = torch.as_tensor(im).to(dtype)
    x = ((x - x.mean()) / (x.std(correction=0) + 1e-6))[None]
    gates, skips = [], []
    with torch.no_grad():
        for i, lvl in enumerate(net.enc):
            for conv in (lvl.a, lvl.b):
                gates.append(TL._norm(conv(x)))
                x = F.relu(gates[-1])
            if i < len(net.enc) - 1:
                skips.append(x)
                x = F.max_pool3d(x, (1, 2, 2), (1, 2, 2), ceil_mode=True)
        for lvl in net.dec:
            skip = skips.pop()
            x = torch.cat([F.interpolate(x, size=skip.shape[2:],
                                         mode="nearest-exact"), skip], 1)
            for conv in (lvl.a, lvl.b):
                gates.append(TL._norm(conv(x)))
                x = F.relu(gates[-1])
    return [g[0].permute(1, 2, 3, 0).double().numpy() for g in gates]


@pytest.mark.parametrize("scene", ["noise", "train"])
def test_loss_and_gradients_match_jax(scene):
    """The loss at rtol 1e-5; each gradient at rtol 1e-4, atol 1e-4 x the
    largest gradient magnitude.  A float32 ReLU input within rounding of 0
    may take another sign in the two packages: its whole upstream gradient
    then flows in one and not the other.  Where JAX's and the port's gates
    all agree, every gradient is held against JAX's; where one differs (it
    must lie within 1e-6 of 0 in both), the port's gradient is held
    against its float64 evaluation, whose gates are the port's float32
    ones, and the head's against JAX's."""
    if scene == "train":
        im, truth = _train_scene()
    else:
        truth = _two_cell_labels()
        im = np.random.default_rng(0).normal(size=(1,) + truth.shape
                                             ).astype(np.float32)
    flow_t, fg = JL.labels_to_flows(truth)
    params = JL.init_unet_params(jax.random.PRNGKey(1), in_channels=1,
                                 base=8, levels=2)
    loss, grads = jax.value_and_grad(JL.unet_loss)(
        params, jnp.asarray(im), jnp.asarray(flow_t), jnp.asarray(fg))
    net = _port(params)
    got = TL.unet_loss(net, im, flow_t, fg)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=1e-5)
    flips = 0
    for a, b in zip(_jax_gates(params, im), _port_gates(_port(params), im)):
        differ = (a > 0) != (b > 0)
        assert (np.abs(a[differ]) < 1e-6).all()
        assert (np.abs(b[differ]) < 1e-6).all()
        flips += int(differ.sum())
    want = _flat(grads)
    if flips:
        net64 = _port(params).double()
        assert all((a > 0).tolist() == (b > 0).tolist() for a, b in zip(
            _port_gates(_port(params), im),
            _port_gates(_port(params), im, torch.float64)))
        TL.unet_loss(net64, torch.as_tensor(im).double(),
                     torch.as_tensor(flow_t).double(), fg).backward()
        ref = {TL.jax_key(n): TL._jax_layout(n, p.grad)
               for n, p in net64.named_parameters()}
    else:
        ref = want
    scale = max(np.abs(v).max() for v in ref.values())
    for name, p in net.named_parameters():
        np.testing.assert_allclose(TL._jax_layout(name, p.grad),
                                   ref[TL.jax_key(name)], rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=name)
        if name.startswith("head"):
            np.testing.assert_allclose(TL._jax_layout(name, p.grad),
                                       want[TL.jax_key(name)], rtol=1e-4,
                                       atol=1e-4 * scale, err_msg=name)


def test_conv_weight_gradient_by_taps_matches_autograd():
    """The UNet's 3x3x3 convolution: its per-tap weight gradient, data and
    bias gradients equal ``F.conv3d``'s autograd (a batch of 2, odd
    sizes)."""
    rng = np.random.default_rng(6)
    x = torch.tensor(rng.normal(size=(2, 3, 5, 7, 6)), dtype=torch.float64)
    w = torch.tensor(rng.normal(size=(4, 3, 3, 3, 3)), dtype=torch.float64)
    b = torch.tensor(rng.normal(size=4), dtype=torch.float64)
    g = torch.tensor(rng.normal(size=(2, 4, 5, 7, 6)), dtype=torch.float64)
    got = [t.clone().requires_grad_() for t in (x, w, b)]
    want = [t.clone().requires_grad_() for t in (x, w, b)]
    TL._Conv3x3x3.apply(*got).backward(g)
    F.conv3d(want[0], want[1], want[2], padding=1).backward(g)
    for a, c in zip(got, want):
        np.testing.assert_allclose(a.grad.numpy(), c.grad.numpy(),
                                   rtol=1e-12, atol=1e-12)


def test_adam_update_matches_optax():
    """Two Adam steps fed the same (JAX) gradients: the port's parameters
    equal optax's after each, at rtol 1e-6 of the parameter or 1e-6 of the
    step size (a weight that a step brings near 0 keeps the rounding of
    its larger terms)."""
    im, truth = _train_scene()
    flow_t, fg = JL.labels_to_flows(truth)
    params = JL.init_unet_params(jax.random.PRNGKey(1), in_channels=1,
                                 base=8, levels=2)
    net = _port(params)
    opt = TL.Adam(net.parameters(), lr=2e-3)
    jopt = optax.adam(2e-3)
    state = jopt.init(params)
    jp = params
    for step in range(2):
        grads = jax.grad(JL.unet_loss)(jp, jnp.asarray(im),
                                       jnp.asarray(flow_t), jnp.asarray(fg))
        updates, state = jopt.update(grads, state)
        jp = optax.apply_updates(jp, updates)
        g = _flat(grads)
        for name, p in net.named_parameters():
            p.grad = TL._from_jax_layout(name, g[TL.jax_key(name)])
        opt.step()
        want = _flat(jp)
        for name, p in net.named_parameters():
            np.testing.assert_allclose(TL._jax_layout(name, p.detach()),
                                       want[TL.jax_key(name)], rtol=1e-6,
                                       atol=1e-6 * 2e-3,
                                       err_msg=f"step {step} {name}")


def _textured_scene():
    """The JAX test's textured nuclei: a touching pair and two isolated
    nuclei with per-nucleus gradients, speckle and an uneven background."""
    shape = (8, 72, 72)
    truth = np.zeros(shape, np.int32)
    truth[_ellipsoid_mask(shape, (4, 18, 20), (3, 9, 9))] = 1
    truth[_ellipsoid_mask(shape, (4, 34, 26), (3, 9, 9))] = 2
    truth[_ellipsoid_mask(shape, (4, 54, 50), (3, 8, 10))] = 3
    truth[_ellipsoid_mask(shape, (4, 18, 52), (3, 8, 8))] = 4
    rng = np.random.default_rng(5)
    im = np.full(shape, 80.0, np.float32)
    yy, xx = np.meshgrid(np.linspace(0, 40, shape[2]),
                         np.linspace(0, 25, shape[1]))
    im += (xx + yy)[None].astype(np.float32)
    for t in range(1, 5):
        m = truth == t
        base = rng.uniform(500.0, 1100.0)
        gdir = rng.normal(0, 1, 3)
        gdir /= np.linalg.norm(gdir)
        zz, xxs, yys = np.nonzero(m)
        proj = (np.stack([zz, xxs, yys], 1)
                - np.array([np.mean(zz), np.mean(xxs), np.mean(yys)])) @ gdir
        im[m] += base * (1.0 + 0.35 * proj / max(np.abs(proj).max(), 1e-6))
    im *= rng.lognormal(0.0, 0.15, shape).astype(np.float32)
    im += rng.normal(0, 25.0, shape).astype(np.float32)
    return im[None], truth


@pytest.mark.parametrize("case", ["synthetic", "downsample", "textured"])
def test_fit_unet_meets_the_jax_iou_bars(case):
    """The JAX tests' scenes, steps, learning rates and initial weights
    (carried over from the same PRNGKey); the port's training and
    segmentation must meet their per-cell IoU bars."""
    if case == "synthetic":
        im, truth = _train_scene()
        key, base, steps, bar = 1, 8, 150, 0.6
    elif case == "downsample":
        truth = _two_cell_labels(shape=(6, 50, 46))
        im = ((truth > 0).astype(np.float32) * 900.0 + 100.0)[None]
        key, base, steps, bar = 4, 8, 120, 0.5
    else:
        im, truth = _textured_scene()
        key, base, steps, bar = 3, 12, 400, 0.8
    net = _port(JL.init_unet_params(jax.random.PRNGKey(key), in_channels=1,
                                    base=base, levels=2))
    before = [p.detach().clone() for p in net.parameters()]
    if case == "downsample":
        trained = TL.fit_unet(net, [im[:, :, ::2, ::2]],
                              [truth[:, ::2, ::2]], n_steps=steps, lr=2e-3)
        labels = TL.segment_fov_learned(im, trained, downsample=(1, 2, 2),
                                        max_cells=8, min_count=10).numpy()
        assert labels.shape == truth.shape
    else:
        trained = TL.fit_unet(net, [im], [truth], n_steps=steps, lr=2e-3)
        labels = TL.segment_cells_learned(im, trained, max_cells=8,
                                          min_count=10).numpy()
    # fit_unet trains a copy, as the JAX package returns new parameters
    assert all(torch.equal(a, b) for a, b in zip(before, net.parameters()))
    assert labels.max() >= truth.max()
    ious = _per_cell_iou(labels, truth)
    assert min(ious) > bar, ious


def test_segment_fov_learned_upsamples_as_jax():
    """Pooling, segmentation and the nearest upsample with edge rows at a
    size that does not divide: on the same weights the labels equal JAX's."""
    truth = _two_cell_labels(shape=(6, 50, 46))
    im = ((truth > 0).astype(np.float32) * 900.0 + 100.0)[None]
    params = JL.init_unet_params(jax.random.PRNGKey(4), in_channels=1,
                                 base=8, levels=2)
    params = JL.fit_unet(params, [im[:, :, ::3, ::3]], [truth[:, ::3, ::3]],
                         n_steps=30, lr=2e-3)
    kw = dict(downsample=(1, 3, 3), max_cells=8, min_count=5)
    want = np.asarray(JL.segment_fov_learned(jnp.asarray(im), params, **kw))
    got = TL.segment_fov_learned(im, _port(params), **kw)
    assert got.shape == truth.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_weights_cross_between_packages(tmp_path):
    params = JL.init_unet_params(jax.random.PRNGKey(0), in_channels=2,
                                 base=8, levels=3)
    im = np.random.default_rng(0).normal(size=(2, 6, 32, 32)).astype(
        np.float32)
    # JAX writes, the port reads
    JL.save_weights(params, str(tmp_path / "jax.npz"))
    like = TL.init_unet_params(7, in_channels=2, base=8, levels=3,
                               device=CPU)
    net = TL.load_weights(str(tmp_path / "jax.npz"), like)
    want_f, want_l = JL.unet_apply(params, jnp.asarray(im))
    with torch.no_grad():
        got_f, got_l = TL.unet_apply(net, im)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f),
                               rtol=1e-4, atol=1e-4)
    # the port writes, JAX reads: the same arrays
    TL.save_weights(net, str(tmp_path / "port.npz"))
    back = JL.load_weights(str(tmp_path / "port.npz"), params)
    for k, v in _flat(params).items():
        np.testing.assert_array_equal(_flat(back)[k], v)
    # a wrong shape or a missing key names the key
    bad = {k: v for k, v in np.load(tmp_path / "port.npz").items()}
    bad["['head']['w']"] = np.zeros((1, 1, 1, 8, 3), np.float32)
    with pytest.raises(ValueError, match=r"\['head'\]\['w'\]"):
        TL.load_weights_from(bad, like)
    del bad["['enc'][1]['b']['b']"]
    with pytest.raises(KeyError, match=r"\['enc'\]\[1\]\['b'\]\['b'\]"):
        TL.load_weights_from(bad, like)


def test_init_needs_a_card_without_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TL.init_unet_params(0)
