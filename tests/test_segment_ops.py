"""The XLA segment ops, GATv2 attention, edge update and ESFM loss against
plain NumPy references (loops over edges, float64), and their gradients
against dense one-hot formulations of the same maths."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gasfm.ops.gatv2 import gatv2_attend, gatv2_attend_pool
from gasfm.ops.segment import (
    gather_segments,
    segment_count,
    segment_max,
    segment_mean,
    segment_softmax,
    segment_sum,
)

KINDS = ["plain", "sorted", "empty_segments", "padded_ids", "edge_mask", "vector_1d"]


def make_case(kind, seed=0, E=48, S=7, D=3):
    """(data, ids, S, mask, sorted) for one layout kind. Padded ids are S
    (one past the last segment) as in the graph layout."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, S, size=E)
    mask = None
    if kind == "empty_segments":
        ids = rng.choice([0, 2, 5], size=E)
    if kind == "padded_ids":
        ids[rng.random(E) < 0.3] = S
    if kind == "edge_mask":
        mask = rng.random(E) < 0.7
    is_sorted = kind == "sorted"
    if is_sorted:
        ids = np.sort(ids)
    shape = (E,) if kind == "vector_1d" else (E, D)
    data = rng.standard_normal(shape).astype(np.float32)
    return data, ids.astype(np.int32), S, mask, is_sorted


def _valid(ids, S, mask):
    ok = (ids >= 0) & (ids < S)
    return ok if mask is None else ok & mask


def np_segment_sum(data, ids, S, mask):
    out = np.zeros((S,) + data.shape[1:])
    for e in np.nonzero(_valid(ids, S, mask))[0]:
        out[ids[e]] += data[e]
    return out


def np_segment_count(ids, S, mask):
    return np_segment_sum(np.ones(ids.shape), ids, S, mask)


def np_segment_max(data, ids, S, mask, neutral):
    out = np.full((S,) + data.shape[1:], -np.inf)
    for e in np.nonzero(_valid(ids, S, mask))[0]:
        out[ids[e]] = np.maximum(out[ids[e]], data[e])
    return np.where(np.isneginf(out), neutral, out)


def np_segment_mean(data, ids, S, mask):
    s = np_segment_sum(data, ids, S, mask)
    c = np_segment_count(ids, S, mask).reshape((S,) + (1,) * (data.ndim - 1))
    return np.where(c > 0, s / np.maximum(c, 1), 0.0)


def np_segment_softmax(logits, ids, S, mask):
    ok = _valid(ids, S, mask)
    out = np.zeros(logits.shape)
    for s in range(S):
        sel = ok & (ids == s)
        if sel.any():
            z = logits[sel].astype(np.float64)
            z = np.exp(z - z.max(axis=0))
            out[sel] = z / z.sum(axis=0)
    return out


def np_gather(table, ids, S):
    return table[np.clip(ids, 0, S - 1)]


def _mask_arg(mask):
    return None if mask is None else jnp.asarray(mask)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("op", ["sum", "max", "mean", "count", "softmax", "gather"])
def test_segment_op_matches_numpy(op, kind):
    data, ids, S, mask, is_sorted = make_case(kind)
    m = _mask_arg(mask)
    if op == "sum":
        got = segment_sum(data, ids, S, m, is_sorted)
        ref = np_segment_sum(data, ids, S, mask)
    elif op == "max":
        got = segment_max(data, ids, S, m, is_sorted, neutral=-7.0)
        ref = np_segment_max(data, ids, S, mask, -7.0)
    elif op == "mean":
        got = segment_mean(data, ids, S, m, is_sorted)
        ref = np_segment_mean(data, ids, S, mask)
    elif op == "count":
        got = segment_count(ids, S, m, is_sorted)
        ref = np_segment_count(ids, S, mask)
    elif op == "softmax":
        got = segment_softmax(data, ids, S, m, is_sorted)
        ref = np_segment_softmax(data, ids, S, mask)
    else:
        table = data[:S] if data.shape[0] >= S else data
        got = gather_segments(table, ids, S)
        ref = np_gather(table, ids, S)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-5, atol=1e-6)


def _onehot(ids, S, mask):
    """(E, S) float one-hot of valid edges: the dense form of the scatter."""
    ok = _valid(ids, S, mask)
    return jnp.asarray((ids[:, None] == np.arange(S)[None, :]) & ok[:, None], jnp.float32)


@pytest.mark.parametrize("kind", ["plain", "padded_ids", "edge_mask"])
@pytest.mark.parametrize("op", ["sum", "mean", "softmax", "gather"])
def test_segment_op_gradients_match_dense(op, kind):
    data, ids, S, mask, is_sorted = make_case(kind, seed=1)
    oh = _onehot(ids, S, mask)
    w = jnp.asarray(np.random.default_rng(2).standard_normal(
        (S if op in ("sum", "mean") else data.shape[0], data.shape[1])), jnp.float32)
    m = _mask_arg(mask)

    if op == "sum":
        f = lambda x: jnp.sum(w * segment_sum(x, ids, S, m))  # noqa: E731
        g = lambda x: jnp.sum(w * (oh.T @ x))  # noqa: E731
    elif op == "mean":
        cnt = jnp.maximum(oh.sum(axis=0), 1.0)[:, None]
        f = lambda x: jnp.sum(w * segment_mean(x, ids, S, m))  # noqa: E731
        g = lambda x: jnp.sum(w * (oh.T @ x) / cnt)  # noqa: E731
    elif op == "softmax":
        def g(x):
            z = jnp.where(oh[:, :, None] > 0, x[:, None, :], -jnp.inf)  # (E, S, D)
            p = jnp.exp(z - jnp.max(z, axis=0, keepdims=True))
            p = jnp.where(oh[:, :, None] > 0, p, 0.0)
            sm = p / jnp.maximum(p.sum(axis=0, keepdims=True), 1e-30)
            return jnp.sum(w * sm.sum(axis=1))

        f = lambda x: jnp.sum(w * segment_softmax(x, ids, S, m))  # noqa: E731
    else:
        clip = jnp.asarray(np.clip(ids, 0, S - 1))
        dense = jnp.asarray(clip[:, None] == jnp.arange(S)[None, :], jnp.float32)
        f = lambda t: jnp.sum(w * gather_segments(t, ids, S))  # noqa: E731
        g = lambda t: jnp.sum(w * (dense @ t))  # noqa: E731
        data = data[:S]

    x = jnp.asarray(data)
    np.testing.assert_allclose(np.asarray(jax.grad(f)(x)), np.asarray(jax.grad(g)(x)),
                               rtol=1e-4, atol=1e-5)


def np_gatv2(xl, xr, att, ids, S, mask, slope=0.2):
    E, H, C = xl.shape
    ok = _valid(ids, S, mask)
    out = np.zeros((S, H, C))
    for s in range(S):
        sel = np.nonzero(ok & (ids == s))[0]
        if sel.size == 0:
            continue
        g = xl[sel] + xr[s][None]
        g = np.where(g >= 0, g, slope * g)
        score = np.einsum("ehc,hc->eh", g, att)
        a = np.exp(score - score.max(axis=0))
        a /= a.sum(axis=0)
        out[s] = np.einsum("eh,ehc->hc", a, xl[sel])
    return out


def _attn_inputs(seed, E, S, H, C):
    rng = np.random.default_rng(seed)
    xl = rng.standard_normal((E, H, C)).astype(np.float32)
    xr = rng.standard_normal((S, H, C)).astype(np.float32)
    att = rng.standard_normal((H, C)).astype(np.float32)
    return xl, xr, att


@pytest.mark.parametrize("E,S,H,C,kind", [
    (40, 6, 2, 4, "plain"),
    (64, 9, 4, 8, "sorted"),
    (50, 8, 1, 3, "padded_ids"),
    (30, 5, 2, 2, "edge_mask"),
])
def test_gatv2_attend_matches_numpy(E, S, H, C, kind):
    _, ids, _, mask, is_sorted = make_case(kind, seed=3, E=E, S=S)
    xl, xr, att = _attn_inputs(4, E, S, H, C)
    got = gatv2_attend(xl, xr, att, ids, S, edge_mask=_mask_arg(mask),
                       indices_are_sorted=is_sorted)
    np.testing.assert_allclose(np.asarray(got), np_gatv2(xl, xr, att, ids, S, mask),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kind", ["plain", "edge_mask"])
def test_gatv2_attend_gradients_match_dense(kind):
    E, S, H, C = 36, 5, 2, 3
    _, ids, _, mask, _ = make_case(kind, seed=5, E=E, S=S)
    xl, xr, att = _attn_inputs(6, E, S, H, C)
    oh = _onehot(ids, S, mask)  # (E, S)
    w = jnp.asarray(np.random.default_rng(7).standard_normal((S, H, C)), jnp.float32)

    def dense(xl, xr, att):
        g = xl[:, None] + xr[None]  # (E, S, H, C)
        g = jnp.where(g >= 0, g, 0.2 * g)
        score = jnp.einsum("eshc,hc->esh", g, att)
        score = jnp.where(oh[:, :, None] > 0, score, -jnp.inf)
        p = jnp.exp(score - jnp.max(score, axis=0, keepdims=True))
        p = jnp.where(oh[:, :, None] > 0, p, 0.0)
        a = p / jnp.maximum(p.sum(axis=0, keepdims=True), 1e-30)
        return jnp.sum(w * jnp.einsum("esh,ehc->shc", a, xl))

    def segment(xl, xr, att):
        return jnp.sum(w * gatv2_attend(xl, xr, att, ids, S, edge_mask=_mask_arg(mask)))

    gs = jax.grad(segment, argnums=(0, 1, 2))(xl, xr, att)
    gd = jax.grad(dense, argnums=(0, 1, 2))(xl, xr, att)
    for a, b in zip(gs, gd):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("frac_valid", [1.0, 0.6])
def test_gatv2_attend_pool_matches_numpy(frac_valid):
    E, H, C = 30, 2, 4
    xl, xr, att = _attn_inputs(8, E, 1, H, C)
    rows = np.random.default_rng(9).random(E) < frac_valid
    got = gatv2_attend_pool(xl, xr, att, jnp.asarray(rows))
    ref = np_gatv2(xl, xr, att, np.zeros(E, np.int32), 1, rows)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-4, atol=1e-5)


def test_edge_combine_matches_numpy():
    from gasfm.data.synthetic import generate_synthetic_scene
    from gasfm.ops.edge_update import edge_combine

    g = generate_synthetic_scene(n_views=6, n_points=60, seed=0).to_scene_graph().graph
    rng = np.random.default_rng(10)
    D = 5
    pe = rng.standard_normal((g.num_edges, D)).astype(np.float32)
    ps = rng.standard_normal((g.num_pts, D)).astype(np.float32)
    pv = rng.standard_normal((g.num_cams, D)).astype(np.float32)
    pg = rng.standard_normal((1, D)).astype(np.float32)
    got = np.asarray(edge_combine(pe, ps, pv, pg, g))
    mask = np.asarray(g.edge_mask)
    pt, cam = np.asarray(g.pt_idx)[mask], np.asarray(g.cam_idx)[mask]
    ref = (pe[mask] + ps[pt] + pv[cam] + pg) / 4.0
    np.testing.assert_allclose(got[mask], ref, rtol=1e-5, atol=1e-6)


def _esfm_conf(hinge: bool, equalize: str):
    from gasfm.config import ConfigFactory

    return ConfigFactory.parse_string(f"""
model {{ view_head {{ enabled = true }}, scenepoint_head {{ enabled = true }} }}
loss {{
  infinity_pts_margin = 0.0001
  pts_grad_equalization_pre_perspective_divide = {str(equalize != "none").lower()}
  normalize_grad_wrt_valid_projections_only = {str(equalize == "valid_only").lower()}
  hinge_loss = {str(hinge).lower()}
  hinge_loss_weight = 1
}}
""")


def _esfm_inputs(seed=0):
    from gasfm.data.synthetic import generate_synthetic_scene

    scene = generate_synthetic_scene(n_views=7, n_points=50, seed=seed).to_scene_graph()
    g = scene.graph
    rng = np.random.default_rng(seed)
    Ps = rng.standard_normal((g.num_cams, 3, 4)).astype(np.float32) * 0.3
    Ps[:, :, :3] += np.eye(3, dtype=np.float32)
    Ps[:, 2, 3] += 3.0  # most points in front, a few behind
    X = np.concatenate([rng.standard_normal((3, g.num_pts)).astype(np.float32),
                        np.ones((1, g.num_pts), np.float32)])
    return scene, Ps, X


def np_esfm(Ps, X, g, margin=1e-4, hinge=True, weight=1.0):
    mask = np.asarray(g.edge_mask)
    cam, pt = np.asarray(g.cam_idx)[mask], np.asarray(g.pt_idx)[mask]
    uv = np.asarray(g.uv, np.float64)[mask]
    proj = np.einsum("eij,je->ei", Ps[cam].astype(np.float64), X[:, pt].astype(np.float64))
    depth = proj[:, 2]
    pos = depth >= margin if hinge else np.abs(depth) >= margin
    reproj = np.linalg.norm(proj[:, :2] / np.where(pos, depth, 1.0)[:, None] - uv, axis=1)
    per = np.where(pos, reproj, (margin - depth) * weight)
    return per.mean()


@pytest.mark.parametrize("hinge", [True, False])
@pytest.mark.parametrize("equalize", ["none", "valid_only", "all"])
def test_esfm_loss_matches_numpy(hinge, equalize):
    """The forward value does not depend on the gradient equalization."""
    from gasfm.losses import ESFMLoss

    scene, Ps, X = _esfm_inputs()
    loss = ESFMLoss(_esfm_conf(hinge, equalize))({"Ps_norm": Ps, "pts3D": X}, scene)
    np.testing.assert_allclose(float(loss), np_esfm(Ps, X, scene.graph, hinge=hinge),
                               rtol=1e-5)


def test_esfm_equalized_gradient_direction():
    """With valid-only equalization, the gradient reaching each positive-depth
    projection is its plain gradient normalized to unit length and divided by
    the number of valid positive projections (reference loss_functions.py:100-110)."""
    from gasfm.losses import _equalize_grads_valid_only

    rng = np.random.default_rng(11)
    proj = jnp.asarray(rng.standard_normal((20, 3)), jnp.float32)
    pos = jnp.asarray(rng.random(20) < 0.6, jnp.float32)
    inv = 1.0 / jnp.maximum(pos.sum(), 1.0)
    w = jnp.asarray(rng.standard_normal((20, 3)), jnp.float32)
    got = jax.grad(lambda p: jnp.sum(w * _equalize_grads_valid_only(p, pos, inv)))(proj)
    wn = np.asarray(w) / np.linalg.norm(np.asarray(w), axis=1, keepdims=True) * float(inv)
    ref = np.where(np.asarray(pos)[:, None] > 0, wn, np.asarray(w))
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-5, atol=1e-7)
