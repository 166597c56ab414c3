"""Port parity for B-AlexNet (`repro_torch.models.convnet`), its data and
latency helpers: the reference's parameters carried across with
`params_from_jax`, the same seeded images through both forwards.

Tolerance: logits and payloads rtol 1e-4 / atol 1e-5 (float32
convolutions summed in another order; no TF32 on the CPU).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import cifar_like as jcifar
from repro.models import convnet as jconv
from repro.offload import latency as jlat
from repro_torch.data.synthetic import cifar_like as tcifar
from repro_torch.models import convnet as tconv
from repro_torch.offload import latency as tlat

RTOL, ATOL = 1e-4, 1e-5


def numpy_params(seed=0):
    """A reference-shaped parameter tree drawn with numpy: N(0, 1/fan_in)
    weights and small nonzero biases (so the bias path is exercised)."""
    rng = np.random.default_rng(seed)

    def draw(node):
        if isinstance(node, dict):
            return {k: draw(v) for k, v in node.items()}
        fan_in = np.prod(node.shape[:-1]) if len(node.shape) > 1 else 100.0
        return (rng.standard_normal(node.shape) / np.sqrt(fan_in)).astype(np.float32)

    return draw(jax.eval_shape(jconv.init_params, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def nets():
    tree = numpy_params()
    jparams = jax.tree.map(jnp.asarray, tree)
    images = np.random.default_rng(0).standard_normal((4, 32, 32, 3)).astype(np.float32)
    return jparams, tconv.params_from_jax(tree, device="cpu"), images


def test_params_from_jax_layouts(nets):
    jparams, tparams, _ = nets
    assert tparams["conv1"]["w"].shape == (64, 3, 5, 5)  # HWIO -> OIHW
    assert tparams["fc1"]["w"].shape == (2048, 256)  # dense as it is
    np.testing.assert_array_equal(tparams["branch1"]["conv"]["w"].numpy(),
                                  np.asarray(jparams["branch1"]["conv"]["w"]).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(tparams["fc1"]["b"].numpy(), np.asarray(jparams["fc1"]["b"]))


def test_init_params_matches_reference_distribution():
    tparams = tconv.init_params(torch.Generator().manual_seed(0), device="cpu")
    jparams = jax.eval_shape(jconv.init_params, jax.random.PRNGKey(0))
    conv = {"conv1", "conv2", "conv3", "conv4", "conv5"}
    for name, jp in jparams.items():
        for sub, leaf in (jp.items() if name.startswith("branch") else [(None, jp)]):
            tp = tparams[name][sub] if sub else tparams[name]
            jw = leaf["w"].shape
            want = (jw[3], jw[2], jw[0], jw[1]) if (name in conv or sub == "conv") else jw
            assert tuple(tp["w"].shape) == tuple(want)
            fan_in = np.prod(jw[:-1])
            assert abs(float(tp["w"].std()) * np.sqrt(fan_in) - 1.0) < 0.1
            assert (tp["b"] == 0).all() and tp["b"].shape == leaf["b"].shape
    with pytest.raises(RuntimeError):
        tconv.init_params()  # no device named and no CUDA: refuse, never fall back


def test_forward_matches_reference(nets):
    jparams, tparams, images = nets
    out_t = tconv.forward(tparams, torch.as_tensor(images))
    out_j = jconv.forward(jparams, jnp.asarray(images))
    np.testing.assert_allclose(out_t["logits"].numpy(), np.asarray(out_j["logits"]),
                               rtol=RTOL, atol=ATOL)
    for a, b in zip(out_t["exit_logits"], out_j["exit_logits"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("branch", [1, 2])
def test_edge_and_cloud_forward_match_reference(nets, branch):
    jparams, tparams, images = nets
    logits, payload = tconv.edge_forward(tparams, torch.as_tensor(images), branch=branch)
    jlogits, jpayload = jconv.edge_forward(jparams, jnp.asarray(images), branch=branch)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=RTOL, atol=ATOL)
    assert payload.is_contiguous() and tuple(payload.shape) == jpayload.shape  # NHWC
    np.testing.assert_allclose(payload.numpy(), np.asarray(jpayload), rtol=RTOL, atol=ATOL)
    assert payload[0].numel() * 4 == tconv.payload_bytes(branch) == jconv.payload_bytes(branch)
    cloud = tconv.cloud_forward(tparams, torch.as_tensor(np.array(jpayload)), from_branch=branch)
    jcloud = jconv.cloud_forward(jparams, jpayload, from_branch=branch)
    np.testing.assert_allclose(cloud.numpy(), np.asarray(jcloud), rtol=RTOL, atol=ATOL)


def test_max_pool_same_matches_reduce_window():
    """The 3x3/2 "SAME" pool pads 0 before and 1 after on even sizes;
    symmetric padding=1 would shift every window."""
    y = np.random.default_rng(1).standard_normal((2, 32, 32, 64)).astype(np.float32)
    want = jax.lax.reduce_window(jnp.asarray(y), -jnp.inf, jax.lax.max,
                                 (1, 3, 3, 1), (1, 2, 2, 1), "SAME")
    got = tconv._max_pool_same(torch.as_tensor(y).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cifar_like_copy_is_identical():
    a = tcifar(n_train=16, n_val=8, n_test=8, seed=4)
    b = jcifar(n_train=16, n_val=8, n_test=8, seed=4)
    for k in ("train_x", "train_y", "val_x", "val_y", "test_x", "test_y"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


def test_latency_tables_match_reference():
    tp, jp = tlat.paper_2020(), jlat.paper_2020()
    assert tp.__dict__ == jp.__dict__
    assert tlat.payload_bytes_table() == jlat.payload_bytes_table()
    for b in (1, 2):
        assert tlat.edge_time(tp, b) == jlat.edge_time(jp, b)
        assert tlat.cloud_time(tp, b) == jlat.cloud_time(jp, b)
        for lvl in (0, 1, 2):
            assert tlat.payload_bytes_for(b, lvl) == jlat.payload_bytes_for(b, lvl)
            assert tlat.comm_time(tp, b, level=lvl) == jlat.comm_time(jp, b, level=lvl)
    assert tlat.energy_per_request_j(tp, 1e-3, 8704) == jlat.energy_per_request_j(jp, 1e-3, 8704)
