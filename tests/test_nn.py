"""The module layer (gasfm.models.nn): parameter names and shapes, init
determinism, apply, remat, intermediates capture."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gasfm.models import nn


class Dense(nn.Module):
    features: int

    def __call__(self, x):
        k = self.param("kernel", nn.initializers.glorot_uniform(), (x.shape[-1], self.features))
        b = self.param("bias", nn.initializers.zeros, (self.features,))
        return x @ k + b


class Block(nn.Module):
    """Compact children, explicit and automatic names."""

    width: int

    def __call__(self, x):
        x = nn.relu(Dense(self.width)(x))
        x = nn.LayerNorm(name="norm")(x)
        x = Dense(self.width)(x)
        return Dense(2, name="out")(x)


class SetupBlock(nn.Module):
    """Setup-style children take their attribute names."""

    width: int

    def setup(self):
        self.first = Dense(self.width)
        self.second = Dense(3)
        self.scale = self.param("scale", nn.initializers.ones, (3,))

    def head(self, x):
        return self.second(nn.relu(self.first(x))) * self.scale

    def __call__(self, x):
        return self.head(x)


class Net(nn.Module):
    def __call__(self, x):
        h = Block(4, name="block")(x)
        return SetupBlock(5)(h) + Dense(3)(h)


def _shapes(tree):
    return {jax.tree_util.keystr(p): v.shape
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_parameter_names_and_shapes():
    params = Net().init(jax.random.PRNGKey(0), jnp.ones((6, 7)))
    assert _shapes(params) == {
        "['params']['block']['Dense_0']['kernel']": (7, 4),
        "['params']['block']['Dense_0']['bias']": (4,),
        "['params']['block']['norm']['scale']": (4,),
        "['params']['block']['norm']['bias']": (4,),
        "['params']['block']['Dense_1']['kernel']": (4, 4),
        "['params']['block']['Dense_1']['bias']": (4,),
        "['params']['block']['out']['kernel']": (4, 2),
        "['params']['block']['out']['bias']": (2,),
        "['params']['SetupBlock_0']['first']['kernel']": (2, 5),
        "['params']['SetupBlock_0']['first']['bias']": (5,),
        "['params']['SetupBlock_0']['second']['kernel']": (5, 3),
        "['params']['SetupBlock_0']['second']['bias']": (3,),
        "['params']['SetupBlock_0']['scale']": (3,),
        "['params']['Dense_0']['kernel']": (2, 3),
        "['params']['Dense_0']['bias']": (3,),
    }


def test_init_is_deterministic_per_seed_and_shape_independent():
    a = Net().init(jax.random.PRNGKey(0), jnp.ones((6, 7)))
    b = Net().init(jax.random.PRNGKey(0), jnp.zeros((11, 7)))
    c = Net().init(jax.random.PRNGKey(1), jnp.ones((6, 7)))
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    ka = np.asarray(a["params"]["block"]["Dense_0"]["kernel"])
    kc = np.asarray(c["params"]["block"]["Dense_0"]["kernel"])
    assert not np.allclose(ka, kc)
    # Two leaves of the same shape draw different values.
    assert not np.allclose(np.asarray(a["params"]["block"]["Dense_1"]["kernel"]),
                           np.asarray(a["params"]["block"]["out"]["kernel"][:, :1]).repeat(4, 1))


def test_apply_matches_hand_written_forward():
    x = jax.random.normal(jax.random.PRNGKey(3), (6, 7))
    params = Net().init(jax.random.PRNGKey(0), x)
    p = params["params"]

    def dense(q, h):
        return h @ q["kernel"] + q["bias"]

    def ln(q, h):
        mu = h.mean(-1, keepdims=True)
        var = ((h - mu) ** 2).mean(-1, keepdims=True)
        return (h - mu) / jnp.sqrt(var + 1e-6) * q["scale"] + q["bias"]

    b = p["block"]
    h = dense(b["out"], dense(b["Dense_1"], ln(b["norm"], jax.nn.relu(dense(b["Dense_0"], x)))))
    s = p["SetupBlock_0"]
    ref = dense(s["second"], jax.nn.relu(dense(s["first"], h))) * s["scale"] + dense(p["Dense_0"], h)
    np.testing.assert_allclose(np.asarray(Net().apply(params, x)), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    head = SetupBlock(5).apply({"params": s}, h, method="head")
    np.testing.assert_allclose(np.asarray(head), np.asarray(ref - dense(p["Dense_0"], h)),
                               rtol=1e-5, atol=1e-5)


def test_layer_norm_matches_numpy():
    x = np.random.default_rng(0).standard_normal((5, 9)).astype(np.float32) * 3 + 1
    ln = nn.LayerNorm(epsilon=1e-5)
    params = ln.init(jax.random.PRNGKey(0), x)
    ref = (x - x.mean(-1, keepdims=True)) / np.sqrt(x.var(-1, keepdims=True) + 1e-5)
    np.testing.assert_allclose(np.asarray(ln.apply(params, x)), ref, rtol=1e-4, atol=1e-5)


def test_remat_gives_identical_values_and_gradients():
    x = jax.random.normal(jax.random.PRNGKey(4), (8, 7))
    params = Block(6).init(jax.random.PRNGKey(0), x)
    plain, rem = Block(6), nn.remat(Block)(6)

    def loss(model, p):
        return jnp.sum(model.apply(p, x) ** 2)

    l0, g0 = jax.value_and_grad(lambda p: loss(plain, p))(params)
    l1, g1 = jax.value_and_grad(lambda p: loss(rem, p))(params)
    # Same maths; XLA may fuse the recomputed forward differently, so
    # float32 reassociation noise is allowed.
    np.testing.assert_allclose(float(l1), float(l0), rtol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(g0), jax.tree_util.tree_leaves(g1)):
        a, b = np.asarray(a), np.asarray(b)
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6 * max(1.0, np.abs(a).max()))
    assert _shapes(rem.init(jax.random.PRNGKey(0), x)) == _shapes(params)


def test_capture_intermediates_records_submodule_outputs():
    x = jnp.ones((3, 7))
    params = Net().init(jax.random.PRNGKey(0), x)
    out, state = Net().apply(params, x, capture_intermediates=True)
    inter = state["intermediates"]
    block_out = inter["block"]["__call__"][0]
    assert block_out.shape == (3, 2)
    np.testing.assert_allclose(np.asarray(Block(4).apply({"params": params["params"]["block"]}, x)),
                               np.asarray(block_out), rtol=1e-6)
    assert inter["__call__"][0].shape == out.shape


def test_errors_for_unbound_calls_and_missing_parameters():
    with pytest.raises(RuntimeError, match="unbound"):
        Dense(3)(jnp.ones((2, 2)))
    params = Net().init(jax.random.PRNGKey(0), jnp.ones((2, 7)))
    del params["params"]["block"]["out"]["bias"]
    with pytest.raises(KeyError, match="block/out/bias"):
        Net().apply(params, jnp.ones((2, 7)))


def test_initializers_follow_the_jax_formulas():
    rng = np.random.default_rng(0)
    g = nn.initializers.glorot_uniform()(rng, (300, 500))
    limit = np.sqrt(6.0 / 800)
    assert g.dtype == np.float32 and np.abs(g).max() <= limit
    assert np.abs(g).max() > 0.99 * limit
    np.testing.assert_allclose(g.std(), limit / np.sqrt(3), rtol=0.02)
    u = nn.initializers.uniform(0.5)(rng, (10000,))
    assert -0.5 <= u.min() and u.max() <= 0.5
    n = nn.initializers.normal(0.1)(rng, (20000,))
    np.testing.assert_allclose(n.std(), 0.1, rtol=0.03)
    assert not nn.initializers.zeros(rng, (3,)).any() and nn.initializers.ones(rng, (3,)).all()


def test_init_refuses_to_run_under_jit():
    with pytest.raises(TypeError, match="outside jit"):
        jax.jit(Net().init)(jax.random.PRNGKey(0), jnp.ones((2, 7)))
